"""IO parity: VCF parsing, genotype decoding, readers, matching."""

import sys

import numpy as np

from vireo_tpu.io.vcf import load_VCF, parse_donor_GPb, match_SNPs
from vireo_tpu.io.matrices import read_cellSNP, read_mtx
from vireo_tpu.ops.matching import match, optimal_match, get_confusion

DATA = "/root/reference/data"


def _ref_mod(name):
    sys.path.insert(0, "/root/reference")
    import importlib
    return importlib.import_module(name)


def test_load_vcf_parity_cell_file(reference):
    ref_vcf = reference.load_VCF(DATA + "/cells.cellSNP.vcf.gz",
                                 biallelic_only=True)
    ours = load_VCF(DATA + "/cells.cellSNP.vcf.gz", biallelic_only=True)
    assert ours["variants"] == ref_vcf["variants"]
    assert ours["samples"] == ref_vcf["samples"]
    assert ours["comments"] == ref_vcf["comments"]
    for k in ref_vcf["FixedINFO"]:
        assert ours["FixedINFO"][k] == ref_vcf["FixedINFO"][k]
    for k in ref_vcf["GenoINFO"]:
        assert ours["GenoINFO"][k] == ref_vcf["GenoINFO"][k], k


def test_load_vcf_parity_donor_file(reference):
    ref_vcf = reference.load_VCF(DATA + "/donors.cellSNP.vcf.gz",
                                 biallelic_only=True, sparse=False,
                                 format_list=["PL"])
    ours = load_VCF(DATA + "/donors.cellSNP.vcf.gz", biallelic_only=True,
                    sparse=False, format_list=["PL"])
    assert ours["variants"] == ref_vcf["variants"]
    assert ours["GenoINFO"]["PL"] == ref_vcf["GenoINFO"]["PL"]
    np.testing.assert_array_equal(ours["n_SNP_tagged"],
                                  ref_vcf["n_SNP_tagged"])


def test_parse_donor_gpb_parity(reference):
    vu = _ref_mod("vireoSNP.utils.vcf_utils")
    ours_vcf = load_VCF(DATA + "/donors.cellSNP.vcf.gz", biallelic_only=True,
                        sparse=False, format_list=["PL"])
    for tag in ["PL"]:
        ref_t = vu.parse_donor_GPb(ours_vcf["GenoINFO"][tag], tag)
        our_t = parse_donor_GPb(ours_vcf["GenoINFO"][tag], tag)
        np.testing.assert_allclose(our_t, ref_t, rtol=1e-12)
    # GT decode incl. missing
    gt_rows = [["0/0", "1|1", "./.", "0/1"], ["1/0", ".", "1/1", "0|0"]]
    np.testing.assert_allclose(parse_donor_GPb(gt_rows, "GT"),
                               vu.parse_donor_GPb(gt_rows, "GT"),
                               rtol=1e-12)


def test_read_cellsnp_parity(reference):
    ours = read_cellSNP(DATA + "/cellSNP_mat")
    ref = reference.read_cellSNP(DATA + "/cellSNP_mat")
    assert (ours["AD"] != ref["AD"]).nnz == 0
    assert (ours["DP"] != ref["DP"]).nnz == 0
    assert list(ours["samples"]) == list(ref["samples"])
    assert ours["variants"] == ref["variants"]


def test_read_mtx_matches_scipy():
    from scipy.io import mmread
    ours = read_mtx(DATA + "/cellSNP_mat/cellSNP.tag.AD.mtx")
    ref = mmread(DATA + "/cellSNP_mat/cellSNP.tag.AD.mtx").tocsc()
    assert (ours != ref).nnz == 0


def test_match_parity(reference):
    x1 = [5, 9, 1]
    x2 = [1, 2, 5, 7, 9]
    np.testing.assert_array_equal(match(x1, x2),
                                  reference.match(x1, x2))
    np.testing.assert_array_equal(match(x2, x1),
                                  reference.match(x2, x1))
    # repeated ref values
    r1 = ["a", "b", "a", "c"]
    r2 = ["a", "c"]
    np.testing.assert_array_equal(match(r1, r2), reference.match(r1, r2))


def test_match_snps_chr_prefix(reference):
    ids1 = ["1_100_A_T", "2_200_G_C"]
    ids2 = ["chr1_100_A_T", "chr2_200_G_C", "chr3_1_A_G"]
    ours = match_SNPs(ids1, ids2)
    vu = _ref_mod("vireoSNP.utils.vcf_utils")
    ref = vu.match_SNPs(ids1, ids2)
    np.testing.assert_array_equal(ours, ref)


def test_optimal_match_parity(reference):
    rng = np.random.RandomState(1)
    X = rng.rand(30, 4, 3)
    Z = X[:, [2, 0, 3, 1], :] + rng.rand(30, 4, 3) * 0.01
    i0, i1 = optimal_match(X, Z)
    r0, r1 = reference.optimal_match(X, Z)
    np.testing.assert_array_equal(i0, r0)
    np.testing.assert_array_equal(i1, r1)


def test_get_confusion_parity():
    bu = _ref_mod("vireoSNP.utils.base_utils")
    ids1 = ["a", "b", "a", "c", "b", "b"]
    ids2 = ["x", "y", "x", "x", "y", "x"]
    m, u1, u2 = get_confusion(ids1, ids2)
    rm, ru1, ru2 = bu.get_confusion(ids1, ids2)
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(u1, ru1)
    np.testing.assert_array_equal(u2, ru2)


def test_write_vcf_roundtrip(tmp_path, reference):
    """GenoINFO_maker + write_VCF output must be reloadable and carry
    the synthesized FORMAT headers."""
    from vireo_tpu.io.vcf import GenoINFO_maker, write_VCF

    cell_dat = load_VCF(DATA + "/cells.cellSNP.vcf.gz", biallelic_only=True)
    rng = np.random.RandomState(0)
    n_var = len(cell_dat["variants"])
    GT_prob = rng.dirichlet([1, 1, 1], size=(n_var, 2))
    AD = rng.poisson(3, size=(n_var, 2))
    DP = AD + rng.poisson(3, size=(n_var, 2))
    cell_dat["samples"] = ["donor0", "donor1"]
    cell_dat["GenoINFO"] = GenoINFO_maker(GT_prob, AD, DP)

    out = str(tmp_path / "out.vcf.gz")
    write_VCF(out, cell_dat)
    back = load_VCF(out, sparse=False, format_list=["GT", "AD", "DP", "PL"])
    assert back["variants"] == cell_dat["variants"]
    assert back["samples"] == ["donor0", "donor1"]
    gt_back = np.array(back["GenoINFO"]["GT"])
    assert gt_back.shape == (n_var, 2)


def test_read_vartrix_and_cli_route(tmp_path, reference):
    """read_vartrix (DP = REF + ALT, io_utils.py:62-88) matches the
    reference loader on synthetic vartrix outputs, and the CLI's
    --vartrixData route runs end to end."""
    import gzip
    import scipy.io
    import scipy.sparse as sp

    rng = np.random.RandomState(4)
    n_var, n_cell, n_donor = 400, 120, 3
    GT = rng.randint(0, 3, size=(n_var, n_donor))
    theta = np.array([0.02, 0.5, 0.98])
    donor = rng.randint(0, n_donor, size=n_cell)
    DP = (rng.rand(n_var, n_cell) < 0.4) * rng.poisson(4, (n_var, n_cell))
    AD = np.random.RandomState(5).binomial(DP, theta[GT[:, donor]])
    REF = DP - AD

    alt_p = str(tmp_path / "alt.mtx")
    ref_p = str(tmp_path / "ref.mtx")
    scipy.io.mmwrite(alt_p, sp.coo_matrix(AD), field="integer")
    scipy.io.mmwrite(ref_p, sp.coo_matrix(REF), field="integer")
    bar_p = str(tmp_path / "barcodes.tsv")
    with open(bar_p, "w") as f:
        for c in range(n_cell):
            f.write("BC%04d-1\n" % c)
    vcf_p = str(tmp_path / "vars.vcf.gz")
    with gzip.open(vcf_p, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i in range(n_var):
            f.write("1\t%d\t.\tA\tC\t.\tPASS\t.\n" % (i + 1))

    from vireo_tpu.io.matrices import read_vartrix
    ours = read_vartrix(alt_p, ref_p, bar_p, vcf_p)
    theirs = reference.read_vartrix(alt_p, ref_p, bar_p, vcf_p)
    assert (ours["AD"] != theirs["AD"]).nnz == 0
    assert (ours["DP"] != theirs["DP"]).nnz == 0
    np.testing.assert_array_equal(ours["samples"], theirs["samples"])
    np.testing.assert_array_equal(ours["variants"], theirs["variants"])

    # full CLI route (mode 1 over vartrix inputs)
    from vireo_tpu.cli.vireo_cli import main as vireo_main
    out = tmp_path / "out"
    vireo_main(["--vartrixData", "%s,%s,%s,%s" % (alt_p, ref_p, bar_p,
                                                  vcf_p),
                "-N", "3", "-o", str(out), "--randSeed", "2",
                "--noPlot"])
    rows = open(out / "donor_ids.tsv").read().splitlines()
    assert rows[0].startswith("cell\tdonor_id")
    assert len(rows) == n_cell + 1
    # planted structure is recovered (labels permuted)
    calls = np.array([r.split("\t")[1] for r in rows[1:]])
    from vireo_tpu.ops.matching import get_confusion
    named = calls != "unassigned"
    ids = np.array([int(c[-1]) if c.startswith("donor") else -1
                    for c in calls])
    conf = get_confusion(ids[named & (ids >= 0)],
                         donor[named & (ids >= 0)])[0]
    acc = conf.max(axis=1).sum() / conf.sum()
    assert acc > 0.95


def test_cli_runs_without_matplotlib(tmp_path, monkeypatch, capsys):
    """matplotlib is optional (setup.py extra "plot"): without it the
    CLI skips the figure, says so, and writes everything else."""
    import sys
    from vireo_tpu.sim.synth import synth_pool_counts, write_cellsnp_dir
    from vireo_tpu.cli import vireo_cli

    pool = synth_pool_counts(n_var=300, n_cell=120, n_donor=3,
                             density=0.3, seed=2)
    cell_dir = str(tmp_path / "cellsnp")
    write_cellsnp_dir(cell_dir, pool["AD"], pool["DP"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "out"
    vireo_cli.main(["-c", cell_dir, "-N", "3", "-o", str(out),
                    "--nInit", "3", "--randSeed", "2"])
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert (out / "donor_ids.tsv").exists()
    assert (out / "GT_donors.vireo.vcf.gz").exists()
    assert not list(out.glob("fig_*"))
