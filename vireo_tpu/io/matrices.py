"""Matrix/result IO: cellSNP + vartrix readers and result writers.

Behavior-compatible with /root/reference/vireoSNP/utils/io_utils.py,
including the hard-call thresholds in `write_donor_id`
(prob_max < 0.9 -> unassigned, doublet >= 0.9 -> doublet,
n_vars < 10 -> unassigned; io_utils.py:97-108).
"""

import subprocess
from itertools import combinations

import numpy as np

from .vcf import load_VCF, match_SNPs

__all__ = ["match_donor_VCF", "read_cellSNP", "read_vartrix", "read_mtx",
           "donor_calls", "write_donor_id", "make_whitelists"]


def read_mtx(path):
    """Fast MatrixMarket coordinate reader -> scipy CSC.

    Drop-in for scipy.io.mmread(...).tocsc() on cellSNP outputs: the
    native C++ parser when available, else np.loadtxt over the body.
    """
    import scipy.sparse as sp
    from .fast import read_mtx_fast
    fast = read_mtx_fast(path)
    if fast is not None:
        return fast
    opener = open
    if path.endswith(".gz"):
        import gzip
        opener = gzip.open
    with opener(path, "rt") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file: %s" % path)
        hdr = header.lower()
        if "coordinate" not in hdr or "general" not in hdr \
                or not ("real" in hdr or "integer" in hdr):
            # 'array' format, non-general symmetry, or a non-numeric
            # field ('pattern' has 2-column entries, 'complex' 4):
            # only scipy's full reader handles these (the native
            # parser refuses them too, so both fast paths land here)
            import scipy.io as sio
            return sp.csc_matrix(sio.mmread(path))
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_row, n_col, nnz = (int(x) for x in line.split())
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if body.size == 0:
        body = np.zeros((0, 3))
    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    vals = body[:, 2]
    return sp.csc_matrix((vals, (rows, cols)), shape=(n_row, n_col))


def match_donor_VCF(cell_dat, donor_vcf):
    """Subset cell data and donor VCF to their matched variants
    (io_utils.py:10-39)."""
    mm_idx = match_SNPs(cell_dat['variants'], donor_vcf['variants'])
    idx1 = np.where(mm_idx != None)[0]  # noqa: E711
    if len(idx1) == 0:
        print("[vireo] warning: no variants matched to donor VCF, "
              "please check chr format!")
    else:
        print("[vireo] %d out %d variants matched to donor VCF"
              % (len(idx1), len(cell_dat['variants'])))
    idx2 = mm_idx[idx1].astype(int)

    cell_dat['AD'] = cell_dat['AD'][idx1, :]
    cell_dat['DP'] = cell_dat['DP'][idx1, :]
    cell_dat["variants"] = [cell_dat["variants"][x] for x in idx1]
    for _key in cell_dat["FixedINFO"].keys():
        cell_dat["FixedINFO"][_key] = [
            cell_dat["FixedINFO"][_key][x] for x in idx1]

    donor_vcf["variants"] = [donor_vcf["variants"][x] for x in idx2]
    for _key in donor_vcf["FixedINFO"].keys():
        donor_vcf["FixedINFO"][_key] = [
            donor_vcf["FixedINFO"][_key][x] for x in idx2]
    for _key in donor_vcf["GenoINFO"].keys():
        donor_vcf["GenoINFO"][_key] = [
            donor_vcf["GenoINFO"][_key][x] for x in idx2]

    return cell_dat, donor_vcf


def _load_variants(vcf_file):
    """Variant-id-only VCF load; native fast path when available."""
    from .fast import load_variants_fast
    dat = load_variants_fast(vcf_file)
    if dat is None:
        dat = load_VCF(vcf_file, load_sample=False, biallelic_only=False)
    return dat


def read_cellSNP(dir_name, layers=['AD', 'DP']):
    """Read a cellSNP output folder (io_utils.py:42-59)."""
    cell_dat = _load_variants(dir_name + "/cellSNP.base.vcf.gz")
    for _layer in layers:
        cell_dat[_layer] = read_mtx(
            dir_name + "/cellSNP.tag.%s.mtx" % _layer)
    cell_dat['samples'] = np.genfromtxt(
        dir_name + "/cellSNP.samples.tsv", dtype=str)
    return cell_dat


def read_vartrix(alt_mtx, ref_mtx, cell_file, vcf_file=None):
    """Read VarTrix outputs; DP = REF + ALT (io_utils.py:62-88)."""
    if vcf_file is not None:
        cell_dat = _load_variants(vcf_file)
        cell_dat['variants'] = np.array(cell_dat['variants'])
    else:
        cell_dat = {}
    cell_dat['AD'] = read_mtx(alt_mtx)
    cell_dat['DP'] = read_mtx(ref_mtx) + cell_dat['AD']
    cell_dat['samples'] = np.genfromtxt(cell_file, dtype=str)
    return cell_dat


def _write_tsv(path, columns, row_iter):
    """Emit a TSV with a header row and per-row string cells."""
    with open(path, "w") as fh:
        fh.write("\t".join(columns) + "\n")
        for cells in row_iter:
            fh.write("\t".join(cells) + "\n")


def _matrix_rows(names, mat, fmt, tail=None):
    """Rows of (name, formatted matrix entries[, tail(i)])."""
    for i, name in enumerate(names):
        cells = [name] + [fmt % v for v in mat[i, :]]
        if tail is not None:
            cells += tail(i)
        yield cells


def donor_calls(res_vireo, donor_names, n_vars):
    """The `donor_id` column of donor_ids.tsv: the best singlet donor,
    "unassigned" below 0.9 or with < 10 covered variants, "doublet" at
    a doublet probability >= 0.9."""
    singlet_p = res_vireo['ID_prob']
    hard_call = np.array(donor_names, "U100")[np.argmax(singlet_p, 1)]
    hard_call[np.max(singlet_p, axis=1) < 0.9] = "unassigned"
    hard_call[np.max(res_vireo['doublet_prob'], axis=1) >= 0.9] = "doublet"
    hard_call[np.asarray(n_vars) < 10] = "unassigned"
    return hard_call


def write_donor_id(out_dir, donor_names, cell_names, n_vars, res_vireo):
    """Write donor_ids.tsv, summary.tsv, probability tables and the log
    (io_utils.py:91-170). Output is byte-identical to the reference —
    the hard-call thresholds (singlet < 0.9 -> unassigned,
    doublet >= 0.9 -> doublet, < 10 covered variants -> unassigned) and
    every format string are part of the compatibility contract."""
    singlet_p = res_vireo['ID_prob']
    pair_p = res_vireo['doublet_prob']

    top_singlet = np.max(singlet_p, axis=1)
    top_pair = np.max(pair_p, axis=1)
    best_singlet = np.array(donor_names, "U100")[np.argmax(singlet_p, 1)]
    pair_names = [",".join(x) for x in combinations(donor_names, 2)]
    best_pair = np.array(pair_names, "U100")[np.argmax(pair_p, 1)]

    hard_call = donor_calls(res_vireo, donor_names, n_vars)

    with open(out_dir + "/_log.txt", "w") as fh:
        fh.write("logLik: %.3e\n" % (res_vireo['LB_doublet']))
        fh.write("thetas: \n%s\n" % (res_vireo['theta_shapes']))

    # big probability tables: native writer when available — byte-
    # identical %.2e formatting, gzip fused into the same pass (the
    # Python per-value loop + external gzip cost ~17 s at 100k cells).
    # The two writers run in THREADS, concurrent with each other and
    # with the donor_ids/summary python loops below: the ctypes call
    # releases the GIL, and at 100k cells the (C, C(K,2)) doublet
    # table alone is ~100 MB of format+gzip work.
    import threading
    from .fast import write_matrix_tsv_fast
    results = {}

    def _native_write(key, path, columns, mat):
        results[key] = write_matrix_tsv_fast(path, columns, cell_names,
                                             mat, "%.2e", gzip_level=4)

    threads = [
        threading.Thread(target=_native_write, args=(
            "singlet", out_dir + "/prob_singlet.tsv.gz",
            ["cell"] + list(donor_names), singlet_p)),
        threading.Thread(target=_native_write, args=(
            "doublet", out_dir + "/prob_doublet.tsv.gz",
            ["cell"] + pair_names, pair_p)),
    ]
    for t in threads:
        t.start()

    call_levels, call_freq = np.unique(hard_call, return_counts=True)
    _write_tsv(out_dir + "/summary.tsv", ["Var1", "Freq"],
               (["%s" % lv, "%d" % n]
                for lv, n in zip(call_levels, call_freq)))
    print("[vireo] final donor size:")
    print("\t".join([str(x) for x in call_levels]))
    print("\t".join([str(x) for x in call_freq]))

    llr = res_vireo['doublet_LLR']
    _write_tsv(
        out_dir + "/donor_ids.tsv",
        ["cell", "donor_id", "prob_max", "prob_doublet", "n_vars",
         "best_singlet", "best_doublet", "doublet_logLikRatio"],
        ([cell_names[i], hard_call[i], "%.2e" % top_singlet[i],
          "%.2e" % top_pair[i], "%d" % n_vars[i], best_singlet[i],
          best_pair[i], "%.3f" % llr[i]]
         for i in range(len(cell_names))))

    for t in threads:
        t.join()
    native_gz = results.get("singlet") and results.get("doublet")
    if not native_gz:
        _write_tsv(out_dir + "/prob_singlet.tsv",
                   ["cell"] + list(donor_names),
                   _matrix_rows(cell_names, singlet_p, "%.2e"))
        _write_tsv(out_dir + "/prob_doublet.tsv",
                   ["cell"] + pair_names,
                   _matrix_rows(cell_names, pair_p, "%.2e"))

    if res_vireo.get('ambient_Psi') is not None:
        ratio = res_vireo['Psi_LLRatio']
        _write_tsv(out_dir + "/prop_ambient.tsv",
                   ["cell"] + list(donor_names) + ['logLik_ratio'],
                   _matrix_rows(cell_names, res_vireo['ambient_Psi'],
                                "%.4e", tail=lambda i: ['%.2f' % ratio[i]]))

    if not native_gz:
        gz = subprocess.Popen(
            ["gzip", "-f", out_dir + "/prob_singlet.tsv",
             out_dir + "/prob_doublet.tsv"], stdout=subprocess.PIPE)
        gz.communicate()


def make_whitelists(donor_id_file, out_prefix):
    """Per-donor barcode whitelists for umi_tools (io_utils.py:172-185)."""
    table = np.genfromtxt(donor_id_file, dtype='str', delimiter='\t')[1:, :]
    table = table[table[:, 1] != 'unassigned', :]
    table = table[table[:, 1] != 'doublet', :]

    for _donor in np.unique(table[:, 1]):
        idx = table[:, 1] == _donor
        barcodes = table[idx, 0]
        with open(out_prefix + "_%s.txt" % _donor, "w") as fid:
            for _line in barcodes:
                fid.write(_line.split('-')[0] + '\n')
