"""Native C++ IO parser: bit-parity with the pure-Python readers on the
bundled reference data, plus fallback behavior."""

import os
import numpy as np
import pytest

DATA = "/root/reference/data"


@pytest.fixture(scope="module")
def native():
    from vireo_tpu.io._native import available
    if not available():
        pytest.skip("native toolchain unavailable")
    return True


def test_cell_vcf_parity(native):
    from vireo_tpu.io.fast import load_cell_vcf_fast
    from vireo_tpu.io.vcf import load_VCF, read_sparse_GeneINFO

    fast = load_cell_vcf_fast(DATA + "/cells.cellSNP.vcf.gz",
                              tags=("AD", "DP"), biallelic_only=True)
    ref = load_VCF(DATA + "/cells.cellSNP.vcf.gz", biallelic_only=True)
    mats = read_sparse_GeneINFO(ref["GenoINFO"], keys=["AD", "DP"])

    assert fast["variants"] == ref["variants"]
    assert fast["samples"] == ref["samples"]
    assert fast["comments"] == ref["comments"]
    assert fast["contigs"] == ref["contigs"]
    for k in ref["FixedINFO"]:
        assert fast["FixedINFO"][k] == ref["FixedINFO"][k]
    for k in ("AD", "DP"):
        assert (fast[k] != mats[k]).nnz == 0


def test_variants_fast_parity(native):
    from vireo_tpu.io.fast import load_variants_fast
    from vireo_tpu.io.vcf import load_VCF

    fast = load_variants_fast(DATA + "/cellSNP_mat/cellSNP.base.vcf.gz")
    ref = load_VCF(DATA + "/cellSNP_mat/cellSNP.base.vcf.gz",
                   load_sample=False, biallelic_only=False)
    assert fast["variants"] == ref["variants"]
    for k in ref["FixedINFO"]:
        assert fast["FixedINFO"][k] == ref["FixedINFO"][k]


def test_mtx_fast_parity(native):
    import scipy.io as sio
    from vireo_tpu.io.fast import read_mtx_fast

    path = DATA + "/cellSNP_mat/cellSNP.tag.AD.mtx"
    fast = read_mtx_fast(path)
    ref = sio.mmread(path).tocsc()
    assert fast.shape == ref.shape
    assert (fast != ref).nnz == 0


def test_read_cellsnp_uses_native(native):
    from vireo_tpu.io.matrices import read_cellSNP

    dat = read_cellSNP(DATA + "/cellSNP_mat")
    assert dat["AD"].shape == (3784, 952)
    assert dat["AD"].nnz == 32444
    assert len(dat["variants"]) == 3784


def test_fallback_when_disabled(monkeypatch):
    from vireo_tpu.io import fast

    monkeypatch.setattr(fast, "_native_lib", lambda: None)
    assert fast.load_cell_vcf_fast("x.vcf") is None
    assert fast.load_variants_fast("x.vcf") is None
    assert fast.read_mtx_fast("x.mtx") is None


def test_mtx_native_csc_unsorted_and_duplicates(tmp_path):
    """The native CSC builder canonicalizes shuffled entry order, and
    files with duplicate (row, col) entries fall back to the summing
    scipy builder — both byte-equal to scipy.io.mmread."""
    import scipy.io
    import scipy.sparse as sp
    from vireo_tpu.io.fast import read_mtx_fast, native_available
    if not native_available():
        pytest.skip("native library unavailable")

    rng = np.random.RandomState(0)
    M = sp.random(37, 23, density=0.3, random_state=rng, format="coo")
    order = rng.permutation(M.nnz)

    shuffled = tmp_path / "shuffled.mtx"
    with open(shuffled, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write("37 23 %d\n" % M.nnz)
        for i in order:
            f.write("%d %d %.6g\n" % (M.row[i] + 1, M.col[i] + 1,
                                      M.data[i]))
    got = read_mtx_fast(str(shuffled))
    want = scipy.io.mmread(str(shuffled)).tocsc()
    assert (got != want).nnz == 0
    assert got.has_sorted_indices

    dup = tmp_path / "dup.mtx"
    with open(dup, "w") as f:
        f.write("%%MatrixMarket matrix coordinate integer general\n")
        f.write("4 3 5\n")
        f.write("1 1 2\n2 2 3\n1 1 5\n4 3 1\n2 2 1\n")  # dups sum
    got = read_mtx_fast(str(dup))
    want = scipy.io.mmread(str(dup)).tocsc()
    assert (got != want).nnz == 0
    assert got[0, 0] == 7 and got[1, 1] == 4


def test_native_tsv_writer_matches_python(tmp_path):
    """write_matrix_tsv_fast is byte-identical to the Python %-format
    row loop (glibc vs CPython %.2e parity)."""
    from vireo_tpu.io.fast import write_matrix_tsv_fast, native_available
    from vireo_tpu.io.matrices import _write_tsv, _matrix_rows
    if not native_available():
        pytest.skip("native library unavailable")
    rng = np.random.RandomState(1)
    mat = np.concatenate([rng.rand(40, 5), rng.rand(40, 5) * 1e-30,
                          rng.randn(40, 5) * 1e3,
                          np.zeros((1, 5))], axis=0)
    names = ["cell%d-1" % i for i in range(mat.shape[0])]
    cols = ["cell", "a", "b", "c", "d", "e"]
    p_nat = tmp_path / "nat.tsv"
    p_py = tmp_path / "py.tsv"
    assert write_matrix_tsv_fast(str(p_nat), cols, names, mat, "%.2e")
    _write_tsv(str(p_py), cols, _matrix_rows(names, mat, "%.2e"))
    assert p_nat.read_bytes() == p_py.read_bytes()


def test_native_union_matches_scipy_path(monkeypatch):
    """The C++ union merge produces exactly the scipy indicator-add +
    searchsorted alignment (disjoint/overlapping patterns, empty rows,
    value alignment)."""
    import scipy.sparse as sp
    from vireo_tpu.ops import counts as CT
    if not CT._native_union.__module__:  # pragma: no cover
        pytest.skip()
    rng = np.random.RandomState(3)
    for _ in range(4):
        V, C = rng.randint(5, 40), rng.randint(5, 60)
        dp = (rng.rand(V, C) < 0.3) * rng.poisson(3, (V, C))
        ad = (rng.rand(V, C) < 0.25) * rng.poisson(2, (V, C))
        A, D = sp.csc_matrix(ad * 1.0), sp.csc_matrix(dp * 1.0)
        got = CT._host_union_triplets(A, D)

        import vireo_tpu.io._native as N
        orig = N.lib
        monkeypatch.setattr(N, "lib", lambda: None)  # force scipy path
        want = CT._host_union_triplets(A, D)
        monkeypatch.setattr(N, "lib", orig)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g, np.float64),
                                          np.asarray(w, np.float64))


def test_mtx_unsupported_banner_falls_back_to_scipy(tmp_path):
    """'array'-format and 'symmetric' MatrixMarket files must NOT be
    claimed by the native coordinate/general parser (an array file's
    2-field size line would parse as nnz=0 — silent data loss; a
    symmetric file would load only the stored triangle). Both fast
    paths refuse and read_mtx lands on scipy.io.mmread."""
    import scipy.io
    from vireo_tpu.io.fast import read_mtx_fast, native_available
    from vireo_tpu.io.matrices import read_mtx

    arr = tmp_path / "arr.mtx"
    with open(arr, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n")
        f.write("2 3\n")
        for v in (1.5, 2.0, 0.0, 4.0, 5.0, 6.5):   # column-major
            f.write("%g\n" % v)

    sym = tmp_path / "sym.mtx"
    with open(sym, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write("3 3 4\n")
        f.write("1 1 2\n2 1 3\n3 2 4\n3 3 5\n")    # lower triangle

    import scipy.sparse as sp
    for path in (arr, sym):
        if native_available():
            assert read_mtx_fast(str(path)) is None
        got = read_mtx(str(path))
        want = sp.csc_matrix(scipy.io.mmread(str(path)))
        assert got.shape == want.shape
        assert (got != want).nnz == 0


def test_native_tsv_writer_rejects_overwide_format(tmp_path):
    """A format/value pair wider than the stack buffer must fail
    loudly (rc != 0) instead of appending past the buffer."""
    from vireo_tpu.io.fast import write_matrix_tsv_fast, native_available
    if not native_available():
        pytest.skip("native library unavailable")
    mat = np.ones((2, 2)) * 1.234567
    ok = write_matrix_tsv_fast(str(tmp_path / "w.tsv"),
                               ["cell", "a", "b"], ["c0", "c1"],
                               mat, "%200.100f")
    assert ok is False


def _heavy_pair(seed=0, n_var=300, n_cell=200):
    """Sparse AD/DP with mismatched patterns, a >15 tail and >127 spikes
    clipped by the int8 transfer."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    DP = (rng.rand(n_var, n_cell) < 0.2) * rng.randint(
        1, 14, size=(n_var, n_cell))
    AD = (DP * rng.rand(n_var, n_cell)).astype(np.int64)
    # AD-only and DP-only entries (pattern union differs from both)
    AD[0, 0], DP[0, 0] = 3, 0
    DP[1, 5], AD[1, 5] = 7, 0
    idx = rng.choice(n_var * n_cell, 60, replace=False)
    DP.flat[idx] = rng.randint(16, 120, 60)
    DP.flat[idx[:5]] = 126
    return (sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float)))


def test_native_encoder_bitmatches_numpy_device_args(native):
    """The fused C++ placement encoder (union -> row ptr -> delta cols
    -> nibble vals) produces BIT-IDENTICAL device args to the numpy
    _triplet_device_args chain, and the scattered DenseCounts match."""
    import jax
    from vireo_tpu.ops import counts as CT

    AD, DP = _heavy_pair()
    rows, cols, ad_v, dp_v = CT._host_union_triplets(AD, DP)
    np_first, np_cols, np_vals, np_ptr = CT._triplet_device_args(
        rows, cols, np.minimum(ad_v, 127), np.minimum(dp_v, 127),
        CT.jnp.int8, n_var=AD.shape[0])
    assert np_ptr

    probe = CT._native_encode_probe(AD, DP)
    assert probe is not None
    assert probe["nnz"] == len(rows)
    assert probe["vmax"] == float(max(ad_v.max(), dp_v.max()))
    nat = CT._native_device_args(probe)
    assert nat is not None
    nat_first, nat_cols, nat_vals, nat_ptr = nat
    assert nat_ptr

    np.testing.assert_array_equal(np.asarray(np_first),
                                  np.asarray(nat_first))
    for a, b in zip(jax.tree.leaves(np_cols), jax.tree.leaves(nat_cols)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(np_vals), jax.tree.leaves(nat_vals)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # end to end through the ladder: exact dense counts
    got = CT.counts_from_scipy(AD, DP, max_dense_elems=0)
    assert got.ad.dtype == CT.jnp.int8
    np.testing.assert_array_equal(np.asarray(got.ad, np.float64),
                                  np.minimum(AD.toarray(), 127))
    np.testing.assert_array_equal(np.asarray(got.dp, np.float64),
                                  np.minimum(DP.toarray(), 127))


def test_native_encoder_fallback_paths(native, monkeypatch):
    """Ladder equality with the encoder disabled, and the high-
    exception fallback to the numpy path."""
    import scipy.sparse as sp
    from vireo_tpu.ops import counts as CT

    AD, DP = _heavy_pair(seed=3)
    want = CT.counts_from_scipy(AD, DP, max_dense_elems=0)
    monkeypatch.setattr(CT, "_native_encode_probe", lambda *a: None)
    got = CT.counts_from_scipy(AD, DP, max_dense_elems=0)
    np.testing.assert_array_equal(np.asarray(want.ad), np.asarray(got.ad))
    np.testing.assert_array_equal(np.asarray(want.dp), np.asarray(got.dp))
    monkeypatch.undo()

    # value-exception-heavy input: _native_device_args declines and
    # the numpy int8-pair path takes over; results still exact
    rng = np.random.RandomState(1)
    DP2 = sp.csc_matrix((rng.rand(40, 30) < 0.5) * 90.0)
    AD2 = sp.csc_matrix((DP2.toarray() * 0.5).astype(np.int64).astype(float))
    probe = CT._native_encode_probe(AD2, DP2)
    assert probe is not None and CT._native_device_args(probe) is None
    got = CT.counts_from_scipy(AD2, DP2, max_dense_elems=0)
    np.testing.assert_array_equal(np.asarray(got.dp, np.float64),
                                  DP2.toarray())


def test_mtx_pattern_field_falls_back_to_scipy(tmp_path):
    """'pattern' (2-column entries) and 'complex' fields must not hit
    the numeric fast paths (np.loadtxt would crash on body[:, 2]);
    read_mtx routes them to scipy.io.mmread."""
    import scipy.io
    import scipy.sparse as sp
    from vireo_tpu.io.fast import read_mtx_fast, native_available
    from vireo_tpu.io.matrices import read_mtx

    pat = tmp_path / "pat.mtx"
    with open(pat, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write("3 4 3\n")
        f.write("1 2\n2 1\n3 4\n")
    if native_available():
        assert read_mtx_fast(str(pat)) is None
    got = read_mtx(str(pat))
    want = sp.csc_matrix(scipy.io.mmread(str(pat)))
    assert got.shape == want.shape
    assert (got != want).nnz == 0


def test_native_probe_does_not_mutate_caller_matrices():
    """A non-canonical CSC input (duplicate entries) must not be
    restructured in place by the placement encoder."""
    import scipy.sparse as sp
    from vireo_tpu.ops import counts as CT

    # direct (data, indices, indptr) build keeps the duplicate row
    # index in column 0 (the coo-style constructor would sum it)
    AD = sp.csc_matrix((np.array([1.0, 2.0, 3.0]),
                        np.array([0, 0, 1]),
                        np.array([0, 2, 3, 3])), shape=(3, 3))
    DP = sp.csc_matrix(np.array([[4.0, 0, 0], [0, 5.0, 0], [0, 0, 0]]))
    assert not AD.has_canonical_format
    nnz_before = AD.nnz
    data_before = AD.data.copy()
    probe = CT._native_encode_probe(AD, DP)
    assert AD.nnz == nnz_before
    np.testing.assert_array_equal(AD.data, data_before)
    if probe is not None:      # encoder sees the summed canonical view
        assert probe["vmax"] == 5.0
        assert probe["nnz"] == 2   # union pattern {(0,0), (1,1)}


def test_native_encoder_fuzz_parity(native):
    """Randomized structural fuzz of the fused encoder vs the numpy
    chain: varying shapes, densities, empty rows/cols, AD/DP pattern
    mismatch, value tails spanning the nibble and int8 cutoffs."""
    import jax
    import scipy.sparse as sp
    from vireo_tpu.ops import counts as CT

    for seed in range(10):
        rng = np.random.RandomState(seed)
        V = int(rng.randint(3, 200))
        C = int(rng.randint(3, 150))
        density = float(rng.choice([0.01, 0.1, 0.4]))
        DP = (rng.rand(V, C) < density) * rng.randint(1, 30, (V, C))
        AD = (DP * rng.rand(V, C)).astype(np.int64)
        if rng.rand() < 0.5:          # extra AD-only entries
            m = (rng.rand(V, C) < 0.02)
            AD = AD + m * 2
        if rng.rand() < 0.5:          # deep tail past int8
            k = rng.randint(1, 5)
            DP.flat[rng.choice(V * C, k, replace=False)] = 200
        A = sp.csc_matrix(AD.astype(float))
        D = sp.csc_matrix(DP.astype(float))
        if A.nnz == 0 and D.nnz == 0:
            continue

        rows, cols, ad_v, dp_v = CT._host_union_triplets(A, D)
        np_args = CT._triplet_device_args(
            rows, cols, np.minimum(ad_v, 127), np.minimum(dp_v, 127),
            CT.jnp.int8, n_var=V)
        probe = CT._native_encode_probe(A, D)
        assert probe is not None, seed
        assert probe["nnz"] == len(rows), seed
        nat_args = CT._native_device_args(probe)
        n_exc = probe["n_val_exc"]
        if nat_args is None:
            assert n_exc >= probe["nnz"] // 8, seed  # declared fallback
            continue
        for side, (a, b) in enumerate(zip(jax.tree.leaves(np_args[:3]),
                                          jax.tree.leaves(nat_args[:3]))):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg="seed=%d leaf=%d" % (seed, side))


def test_native_hybrid_rung_matches_numpy_path(native, monkeypatch):
    """The int8-hybrid layout (clipped base + overflow residual) built
    via the native encoder is BIT-IDENTICAL to the numpy
    _hybrid_from_triplets path: base, residual arrays, and the
    binomial correction."""
    import jax
    import scipy.sparse as sp
    from vireo_tpu.ops import counts as CT

    AD, DP = _heavy_pair(seed=7)
    # push a tail past the int8 cap so the residual is real
    D = DP.toarray()
    A = AD.toarray()
    rng = np.random.RandomState(1)
    idx = rng.choice(D.size, 25, replace=False)
    D.flat[idx] = rng.randint(200, 2000, 25)
    A.flat[idx] = (D.flat[idx] * 0.6).astype(np.int64)
    AD, DP = sp.csc_matrix(A), sp.csc_matrix(D)

    kw = dict(max_dense_elems=0,
              dense_budget=3.0 * A.size)   # forces the hybrid rung
    got = CT.counts_from_scipy(AD, DP, **kw)
    assert isinstance(got, CT.HybridCounts) and got.cap == 127
    assert got.resid_nnz == 25

    monkeypatch.setattr(CT, "_native_encode_probe", lambda *a: None)
    want = CT.counts_from_scipy(AD, DP, **kw)
    monkeypatch.undo()
    assert isinstance(want, CT.HybridCounts)

    np.testing.assert_array_equal(np.asarray(got.base.ad),
                                  np.asarray(want.base.ad))
    np.testing.assert_array_equal(np.asarray(got.base.dp),
                                  np.asarray(want.base.dp))
    for a, b in zip(jax.tree.leaves(got.resid),
                    jax.tree.leaves(want.resid)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(float(got.binom_corr),
                               float(want.binom_corr), rtol=1e-12)

    # contractions exact vs the true dense matrices
    W = np.random.RandomState(5).rand(A.shape[1], 3)
    S1, SS = (np.asarray(x)
              for x in got.suff_stats(CT.jnp.asarray(W)))
    np.testing.assert_allclose(S1, A @ W, rtol=1e-10)
    np.testing.assert_allclose(SS, D @ W, rtol=1e-10)


def test_native_library_keyed_on_source_content(monkeypatch, tmp_path):
    """The library path follows the source's content, not its mtime: a
    copy with the same bytes maps to the same name, an edited copy to
    another, so a library built from other source is never loaded."""
    import shutil
    from vireo_tpu.io._native import build
    src = tmp_path / "vcfio.cpp"
    shutil.copy(build._SRC, src)
    here = build.so_path()
    monkeypatch.setattr(build, "_SRC", str(src))
    os.utime(src, (0, 0))
    assert build.so_path() == here
    with open(src, "a") as f:
        f.write("\n// edited\n")
    assert build.so_path() != here
    assert os.path.basename(build.so_path()).startswith("_vcfio-")
