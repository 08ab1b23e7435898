"""Dense vs sparse Counts backend equivalence."""

import numpy as np
import pytest
import jax.numpy as jnp

from vireo_tpu.ops.counts import dense_counts, sparse_counts


def _both(small_data):
    AD, DP, _ = small_data
    d = dense_counts(AD, DP, dtype=jnp.float64)
    s = sparse_counts(AD, DP, dtype=jnp.float64, pad_multiple=64)
    return d, s


def test_shapes(small_data):
    d, s = _both(small_data)
    assert d.n_var == s.n_var and d.n_cell == s.n_cell


def test_suff_stats_equal(small_data):
    d, s = _both(small_data)
    rng = np.random.RandomState(0)
    W = jnp.asarray(rng.rand(d.n_cell, 4))
    S1d, SSd = d.suff_stats(W)
    S1s, SSs = s.suff_stats(W)
    np.testing.assert_allclose(np.asarray(S1d), np.asarray(S1s), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(SSd), np.asarray(SSs), rtol=1e-10)


def test_cell_loglik_equal(small_data):
    d, s = _both(small_data)
    rng = np.random.RandomState(1)
    Wa = jnp.asarray(rng.randn(d.n_var, 4))
    Wd = jnp.asarray(rng.randn(d.n_var, 4))
    np.testing.assert_allclose(np.asarray(d.cell_loglik(Wa, Wd)),
                               np.asarray(s.cell_loglik(Wa, Wd)),
                               rtol=1e-10, atol=1e-10)


def test_reductions_equal(small_data):
    d, s = _both(small_data)
    np.testing.assert_allclose(float(d.binom_coeff_sum()),
                               float(s.binom_coeff_sum()), rtol=1e-10)
    ad_d, dp_d = d.row_sums()
    ad_s, dp_s = s.row_sums()
    np.testing.assert_allclose(np.asarray(ad_d), np.asarray(ad_s))
    np.testing.assert_allclose(np.asarray(dp_d), np.asarray(dp_s))
    np.testing.assert_array_equal(np.asarray(d.n_vars_per_cell()),
                                  np.asarray(s.n_vars_per_cell()))


def test_densify_roundtrip(small_data):
    AD, DP, _ = small_data
    s = sparse_counts(AD, DP, dtype=jnp.float64, pad_multiple=64)
    d = s.densify()
    np.testing.assert_allclose(np.asarray(d.ad), AD.toarray())
    np.testing.assert_allclose(np.asarray(d.dp), DP.toarray())


# ---------------------------------------------------------------------
# Backend auto-selection ladder (counts_from_scipy) and the densify
# overflow guard — the production fast-path plumbing.
# ---------------------------------------------------------------------

def _pair(vmax, n_var=30, n_cell=20, seed=0):
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    DP = (rng.rand(n_var, n_cell) < 0.3) * rng.randint(
        1, max(int(vmax), 2), size=(n_var, n_cell))
    DP.flat[0] = vmax  # pin the max
    AD = (DP * rng.rand(n_var, n_cell)).astype(np.int64)
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float))


def test_counts_from_scipy_dtype_ladder():
    from vireo_tpu.ops.counts import (counts_from_scipy, DenseCounts,
                                      SparseCounts, exact_count_dtype)
    assert exact_count_dtype(100) == jnp.int8
    assert exact_count_dtype(200) == jnp.bfloat16
    assert exact_count_dtype(5000) == jnp.float32

    for vmax, want in ((90, jnp.int8), (200, jnp.bfloat16),
                       (5000, jnp.float32)):
        AD, DP = _pair(vmax)
        c = counts_from_scipy(AD, DP, max_dense_elems=10)  # force ladder
        assert isinstance(c, DenseCounts)
        assert c.ad.dtype == want and c.dp.dtype == want
        np.testing.assert_array_equal(
            np.asarray(c.dp, np.float64), DP.toarray())
        np.testing.assert_array_equal(
            np.asarray(c.ad, np.float64), AD.toarray())

    # dense cannot fit the budget -> COO backend
    AD, DP = _pair(90)
    c = counts_from_scipy(AD, DP, max_dense_elems=10, dense_budget=16)
    assert isinstance(c, SparseCounts)

    # small matrices keep the full-precision golden-parity path
    c = counts_from_scipy(AD, DP, dtype=jnp.float64)
    assert isinstance(c, DenseCounts) and c.ad.dtype == jnp.float64


def test_densify_overflow_promotes(capsys):
    from vireo_tpu.ops.counts import sparse_counts

    AD, DP = _pair(200)
    coo = sparse_counts(AD, DP)
    dense = coo.densify(dtype=jnp.int8)  # must refuse to truncate
    assert dense.dp.dtype == jnp.bfloat16
    assert "exceed the exact range" in capsys.readouterr().out
    np.testing.assert_array_equal(np.asarray(dense.dp, np.float64),
                                  DP.toarray())

    # unchecked int8 saturates (never wraps) — benchmark-only escape
    clipped = coo.densify(dtype=jnp.int8, check_overflow=False)
    assert clipped.dp.dtype == jnp.int8
    assert float(jnp.max(clipped.dp)) == 127.0

    # deep counts promote all the way to f32
    AD, DP = _pair(5000)
    dense = sparse_counts(AD, DP).densify(dtype=jnp.int8)
    assert dense.dp.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(dense.dp, np.float64),
                                  DP.toarray())


def test_em_on_auto_int8_matches_f64(small_data):
    """The int8 dense layout runs the same EM trajectory as float64 at
    small scale (counts are exact integers in both)."""
    from vireo_tpu.ops.counts import counts_from_scipy, dense_counts
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors, fit_vb)

    AD, DP, _ = small_data
    c8 = counts_from_scipy(AD, DP, max_dense_elems=10)
    assert c8.ad.dtype == jnp.int8
    c64 = dense_counts(AD, DP, dtype=jnp.float64)

    cfg = VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=3)
    np.random.seed(7)
    state = init_state(cfg, dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)
    r8 = fit_vb(c8, state, priors, cfg, max_iter=12, min_iter=3)
    r64 = fit_vb(c64, state, priors, cfg, max_iter=12, min_iter=3)
    np.testing.assert_allclose(float(r8.elbo_final),
                               float(r64.elbo_final), rtol=1e-6)
    np.testing.assert_array_equal(
        np.argmax(np.asarray(r8.state.id_prob), 1),
        np.argmax(np.asarray(r64.state.id_prob), 1))


def test_coo_f32_reduction_precision():
    """The compensated prefix-sum fast path must stay as accurate as
    sorted segment_sum in f32 (advisor round-2: the naive block cumsum
    reached ~4.6 abs error at 320k nnz from boundary cancellation)."""
    import dataclasses
    import scipy.sparse as sp

    rng = np.random.RandomState(0)
    V, C, nnz_t = 500, 2000, 80000
    rows = rng.randint(0, V, nnz_t)
    cols = rng.randint(0, C, nnz_t)
    dp = 1 + rng.poisson(2.0, nnz_t)
    ad = rng.binomial(dp, 0.3)
    DP = sp.csr_matrix((dp.astype(np.float64), (rows, cols)), shape=(V, C))
    AD = sp.csr_matrix((ad.astype(np.float64), (rows, cols)), shape=(V, C))

    coo = sparse_counts(AD, DP, dtype=jnp.float32)
    assert coo.row_ptr is not None  # fast path engaged
    d64 = dense_counts(AD, DP, dtype=jnp.float64)
    coo_exact = dataclasses.replace(coo, row_ptr=None, col_ptr=None)

    K = 8
    Wa = jnp.asarray(rng.randn(V, K))
    Wd = jnp.asarray(rng.randn(V, K))
    ref = np.asarray(d64.cell_loglik(Wa, Wd))
    fast = np.asarray(coo.cell_loglik(Wa.astype(jnp.float32),
                                      Wd.astype(jnp.float32)))
    segs = np.asarray(coo_exact.cell_loglik(Wa.astype(jnp.float32),
                                            Wd.astype(jnp.float32)))
    assert np.abs(fast - ref).max() <= 2 * max(np.abs(segs - ref).max(),
                                               1e-6)

    W = jnp.asarray(rng.rand(C, K))
    S1r, SSr = d64.suff_stats(W)
    S1, SS = coo.suff_stats(W.astype(jnp.float32))
    assert np.abs(np.asarray(S1) - np.asarray(S1r)).max() < 1e-3
    assert np.abs(np.asarray(SS) - np.asarray(SSr)).max() < 1e-3


def test_coo_exact_env_knob(monkeypatch, small_data):
    """VIREO_COO_EXACT=1 builds without segment pointers."""
    AD, DP, _ = small_data
    monkeypatch.setenv("VIREO_COO_EXACT", "1")
    s = sparse_counts(AD, DP, dtype=jnp.float64, pad_multiple=64)
    assert s.row_ptr is None and s.col_ptr is None
    d = dense_counts(AD, DP, dtype=jnp.float64)
    W = jnp.asarray(np.random.RandomState(3).rand(d.n_cell, 4))
    np.testing.assert_allclose(np.asarray(s.suff_stats(W)[0]),
                               np.asarray(d.suff_stats(W)[0]), rtol=1e-10)


def test_densify_and_pack_chunked_scatter(small_data, monkeypatch):
    """The chunked device scatter (fori_loop over nnz blocks — the
    path every large pool takes) produces the same dense/packed layouts as the single-call path."""
    import os
    AD, DP, _ = small_data
    s = sparse_counts(AD, DP, dtype=jnp.float64, pad_multiple=64)

    monkeypatch.setenv("VIREO_SCATTER_BLOCK", "64")
    d = s.densify(dtype=jnp.int8, check_overflow=False)
    p = s.pack(clip=True)
    monkeypatch.delenv("VIREO_SCATTER_BLOCK")
    d_ref = s.densify(dtype=jnp.int8, check_overflow=False)
    p_ref = s.pack(clip=True)

    np.testing.assert_array_equal(np.asarray(d.ad), np.asarray(d_ref.ad))
    np.testing.assert_array_equal(np.asarray(d.dp), np.asarray(d_ref.dp))
    np.testing.assert_array_equal(np.asarray(p.densify().ad),
                                  np.asarray(p_ref.densify().ad))
    np.testing.assert_array_equal(np.asarray(p.densify().dp),
                                  np.asarray(p_ref.densify().dp))


def test_cols_delta_roundtrip():
    """Transfer delta-encoding of sorted-run column ids reconstructs
    exactly on device (row-boundary jumps, >=256 gaps, padding), and
    falls back to plain int32 when exceptions dominate."""
    import jax.numpy as jnp
    from vireo_tpu.ops.counts import _encode_cols_delta, _decode_cols

    rng = np.random.RandomState(0)
    # several "rows" of ascending cols: mostly small gaps, a few
    # >= 256 (exceptions), plus the padding tail
    def run(n):
        gaps = rng.randint(1, 120, size=n)
        gaps[rng.rand(n) < 0.05] += 900
        return np.cumsum(gaps)
    cols = np.concatenate([run(500), run(1), run(300),
                           np.zeros(219, np.int64)])
    enc = _encode_cols_delta(cols)
    assert isinstance(enc, tuple), "expected the delta encoding"
    got = np.asarray(_decode_cols(enc))
    np.testing.assert_array_equal(got, cols)

    # alternating huge jumps -> exceptions dominate -> plain int32
    wild = np.arange(100) * 300
    wild = wild[::-1].copy()                     # descending: all exc
    enc = _encode_cols_delta(wild)
    assert not isinstance(enc, tuple)
    np.testing.assert_array_equal(np.asarray(_decode_cols(enc)), wild)

    # no exceptions at all (single dense run from col 0)
    enc = _encode_cols_delta(np.arange(50))
    got = np.asarray(_decode_cols(enc))
    np.testing.assert_array_equal(got, np.arange(50))


def _mesh2d_sharding(nv, nc):
    from jax.sharding import NamedSharding
    from vireo_tpu.parallel.mesh import make_mesh2d, count_spec
    mesh = make_mesh2d(nv, nc)
    return mesh, NamedSharding(mesh, count_spec(mesh))


def test_packed_rung_on_mesh2d_shards_cell_axis(small_data):
    """On a 2-D vars x cells mesh the packed rung must split cells
    along the CELLS axis (advisor round-4: the first non-None spec
    axis is 'vars', which split packed bytes over the wrong extent
    and replicated them across cells)."""
    import scipy.sparse as sp
    from vireo_tpu.ops.counts import counts_from_scipy
    from vireo_tpu.ops.packed import MeshPackedCounts
    from vireo_tpu.parallel.mesh import CELL_AXIS

    AD, DP, _ = small_data
    AD = sp.csc_matrix(np.minimum(AD.toarray(), 15.0))
    DP = sp.csc_matrix(np.minimum(DP.toarray(), 15.0))
    mesh, sharding = _mesh2d_sharding(2, 4)
    n_elems = AD.shape[0] * AD.shape[1]
    got = counts_from_scipy(AD, DP, max_dense_elems=0,
                            dense_budget=1.5 * n_elems,
                            sharding=sharding)
    assert isinstance(got, MeshPackedCounts)
    assert got.axis == CELL_AXIS
    assert got.n_shards == 4

    # contraction parity against the exact dense pair
    W = np.random.RandomState(5).rand(AD.shape[1], 3)
    S1, SS = (np.asarray(x) for x in got.suff_stats(jnp.asarray(W)))
    np.testing.assert_allclose(S1, AD.toarray() @ W, rtol=1e-6)
    np.testing.assert_allclose(SS, DP.toarray() @ W, rtol=1e-6)


def test_packed_budget_counts_cell_extent_only(small_data, monkeypatch):
    """The packed rungs' auto budget aggregates over the CELL extent
    only (MeshPackedCounts is 1-D): a per-chip budget that would fit
    packed bytes over all 8 devices but not over the 4 cell shards
    must NOT admit the packed rung (it would overshoot per-chip HBM
    ~Nv-fold at the boundary)."""
    import scipy.sparse as sp
    from vireo_tpu.ops.counts import counts_from_scipy, SparseCounts

    AD, DP, _ = small_data
    AD = sp.csc_matrix(np.minimum(AD.toarray(), 15.0))
    DP = sp.csc_matrix(np.minimum(DP.toarray(), 15.0))
    mesh, sharding = _mesh2d_sharding(2, 4)
    n_elems = AD.shape[0] * AD.shape[1]
    # per-chip budget: E/6 -> dense (2E > 8p) and packed (E > 4p)
    # both fail; the pre-fix factor-8 sizing would have taken packed
    monkeypatch.setenv("VIREO_DENSE_BUDGET_GB",
                       repr(n_elems / 6.0 / 2**30))
    got = counts_from_scipy(AD, DP, max_dense_elems=0, sharding=sharding)
    assert isinstance(got, SparseCounts)


def test_densify_uneven_vars_on_mesh2d_stays_sharded(small_data):
    """Scatter-densify with a 2-D sharding whose vars extent does not
    divide n_var: the result must be correct AND land on the requested
    sharding via an extent-padded sharded scatter (advisor round-4:
    the old fallback materialized the FULL dense pair on one device —
    the exact matrix a capacity mesh exists to avoid)."""
    import scipy.sparse as sp
    from vireo_tpu.ops.counts import counts_from_scipy, DenseCounts

    from jax.sharding import NamedSharding, PartitionSpec as P
    AD, DP, _ = small_data
    AD, DP = AD[:57, :], DP[:57, :]      # 57 % 2 != 0 on the vars axis
    mesh, sharding = _mesh2d_sharding(2, 4)
    with pytest.warns(UserWarning, match="not divisible"):
        got = counts_from_scipy(AD, DP, max_dense_elems=0,
                                sharding=sharding)
    assert isinstance(got, DenseCounts)
    assert got.ad.shape == (57, 40)
    # vars axis dropped (57 % 2 != 0), cells axis kept: still sharded
    want = NamedSharding(mesh, P(None, "cells"))
    assert got.ad.sharding.is_equivalent_to(want, 2)
    np.testing.assert_array_equal(np.asarray(got.ad, dtype=np.float64),
                                  AD.toarray())
    np.testing.assert_array_equal(np.asarray(got.dp, dtype=np.float64),
                                  DP.toarray())


def test_nibble_value_transfer_roundtrip():
    """The placement transfer's nibble value packing: one byte per
    AD/DP pair with an exception list for counts > 15 — decode must be
    exact, and value-heavy inputs must fall back to the int8 pair."""
    import jax
    from vireo_tpu.ops.counts import _encode_vals_nibble, _decode_vals

    rng = np.random.RandomState(0)
    n = 5000
    dp = rng.randint(0, 12, n)
    ad = np.minimum(rng.randint(0, 12, n), dp)
    # sprinkle a heavy tail (~2%) above the nibble cap
    idx = rng.choice(n, n // 50, replace=False)
    dp[idx] = rng.randint(16, 128, len(idx))
    ad[idx] = np.minimum(dp[idx], rng.randint(16, 128, len(idx)))

    vals = _encode_vals_nibble(ad, dp)
    assert len(vals) == 4                       # packed + exceptions
    assert vals[0].dtype == jnp.uint8
    got_ad, got_dp = (np.asarray(x) for x in jax.jit(_decode_vals)(vals))
    np.testing.assert_array_equal(got_ad, ad)
    np.testing.assert_array_equal(got_dp, dp)

    # majority-large values: packing would lose to the exception list
    big_dp = rng.randint(20, 127, n)
    vals = _encode_vals_nibble(np.minimum(big_dp, 30), big_dp)
    assert len(vals) == 2 and vals[0].dtype == jnp.int8

    # empty
    vals = _encode_vals_nibble(np.zeros(0), np.zeros(0))
    a, d = (np.asarray(x) for x in _decode_vals(vals))
    assert a.size == 0 and d.size == 0


def test_densify_with_nibble_exceptions_exact(small_data):
    """End-to-end scatter through the nibble transfer with a planted
    heavy tail: dense int8 result matches the exact matrices."""
    import scipy.sparse as sp
    from vireo_tpu.ops.counts import counts_from_scipy, DenseCounts

    AD, DP, _ = small_data
    A, D = AD.toarray(), DP.toarray()
    # plant counts above the nibble cap but inside int8
    D[:3, :5] = 90.0
    A[:3, :5] = 60.0
    AD, DP = sp.csc_matrix(A), sp.csc_matrix(D)
    got = counts_from_scipy(AD, DP, max_dense_elems=0)
    assert isinstance(got, DenseCounts) and got.ad.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(got.ad, np.float64), A)
    np.testing.assert_array_equal(np.asarray(got.dp, np.float64), D)


def test_host_union_does_not_mutate_caller(monkeypatch):
    """_host_union_triplets (the non-native fallback) must not
    canonicalize a shared-buffer CSR input in place (round-5 review:
    csr_matrix(X) on a CSR shares indptr/data)."""
    import scipy.sparse as sp
    from vireo_tpu.ops import counts as CT
    import vireo_tpu.io._native as N

    AD = sp.csr_matrix((np.array([1.0, 2.0, 3.0]),
                        np.array([0, 0, 1]),
                        np.array([0, 2, 3, 3])), shape=(3, 3))
    DP = sp.csr_matrix(np.array([[4.0, 0, 0], [0, 5.0, 0], [0, 0, 0]]))
    assert not AD.has_canonical_format
    nnz_before, data_before = AD.nnz, AD.data.copy()

    monkeypatch.setattr(N, "lib", lambda: None)   # force scipy path
    rows, cols, a, d = CT._host_union_triplets(AD, DP)
    assert AD.nnz == nnz_before
    np.testing.assert_array_equal(AD.data, data_before)
    # union is over the CANONICAL view: (0,0)=3 summed, (1,1)
    np.testing.assert_array_equal(rows, [0, 1])
    np.testing.assert_array_equal(a, [3.0, 3.0])
    np.testing.assert_array_equal(d, [4.0, 5.0])


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform, self.device_kind, self._stats = platform, "fake", stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,want", [
    ("cpu", None, 16 * 2**30),
    ("gpu", {"bytes_limit": 60 * 2**30}, 0.55 * 60 * 2**30),
    ("gpu", {}, RuntimeError),
    ("gpu", None, RuntimeError),
])
def test_device_dense_budget(monkeypatch, platform, stats, want):
    """0.55 x bytes_limit where the device reports one; the 16 GiB
    default applies to the CPU platform only — a GPU without a limit
    is an error, not a guess."""
    import jax
    from vireo_tpu.ops import counts as C
    monkeypatch.delenv("VIREO_DENSE_BUDGET_GB", raising=False)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice(platform, stats)])
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="no memory limit"):
            C.device_dense_budget()
    else:
        assert C.device_dense_budget() == want


@pytest.mark.parametrize("block_rows", [None, 7])
@pytest.mark.parametrize("count_dtype", [jnp.int8, jnp.bfloat16,
                                         jnp.float32])
def test_dense_contractions_exact_over_row_blocks(monkeypatch, block_rows,
                                                  count_dtype):
    """Dense contractions run over row blocks (a remainder block
    included) at HIGHEST precision: with f32 weights they equal the f64
    product of the same weights to f32 rounding, for positive
    posteriors and signed log weights alike."""
    from vireo_tpu.ops import counts as C
    rng = np.random.RandomState(3)
    V, C_, K = 60, 90, 16
    DP = (rng.rand(V, C_) < 0.5) * rng.randint(1, 120, (V, C_))
    AD = rng.binomial(DP, 0.4)
    if block_rows is not None:
        itemsize = jnp.dtype(count_dtype).itemsize
        monkeypatch.setattr(C, "ROW_BLOCK_BYTES", block_rows * C_ * itemsize)
    c = C.DenseCounts(jnp.asarray(AD, count_dtype),
                      jnp.asarray(DP, count_dtype))
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    W, Wa, Wd = (f32(x) for x in (rng.rand(C_, K), rng.randn(V, K) * 3,
                                  -rng.gamma(2.0, 1.0, (V, K))))
    got = c.suff_stats(W) + (c.cell_loglik(Wa, Wd),)
    W, Wa, Wd = (np.asarray(x, np.float64) for x in (W, Wa, Wd))
    want = (AD @ W, DP @ W, AD.T @ Wa + DP.T @ Wd)
    for g, w in zip(got, want):
        assert g.dtype == jnp.float32 and g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g, np.float64), w,
                                   rtol=1e-5, atol=1e-4)
