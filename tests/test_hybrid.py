"""HybridCounts (clipped base + overflow residual) exactness tests.

The hybrid layout splits integer counts linearly around a cap
(X = min(X, cap) + overflow), so every linear contraction must be
EXACT vs the f64 dense reference up to the base layout's matmul class
(int8->bf16 inputs are exact integers <= 127; packed blocks unpack
to the same int8 operand).
The binomial-coefficient sum is non-linear and covered by a build-time
scalar correction.
"""

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
import pytest

from vireo_tpu.ops.counts import (dense_counts, sparse_counts,
                                  hybrid_from_coo, counts_from_scipy,
                                  DenseCounts, SparseCounts, HybridCounts)
from vireo_tpu.ops.packed import PackedCounts, PACK_MAX


@pytest.fixture(scope="module")
def heavy_data():
    """Sparse counts with a planted heavy tail: most entries are small
    UMI-scale depths, ~7% of nonzeros run into the hundreds (above both
    the int8 cap 127 and the nibble cap 15)."""
    rng = np.random.RandomState(5)
    V, C = 50, 40          # C divisible by the 8-device test mesh
    DP = (rng.rand(V, C) < 0.3) * rng.poisson(3, size=(V, C))
    hot = (DP > 0) & (rng.rand(V, C) < 0.07)
    DP = DP + hot * rng.randint(150, 700, size=(V, C))
    AD = rng.binomial(DP.astype(int), 0.4)
    assert DP.max() > 256          # beyond the bf16-exact rung too
    return (sp.csc_matrix(AD.astype(float)),
            sp.csc_matrix(DP.astype(float)))


def _hybrid(heavy_data, cap, kind):
    AD, DP = heavy_data
    coo = sparse_counts(AD, DP, dtype=jnp.float64, pad_multiple=64)
    h = hybrid_from_coo(coo, cap, kind, pad_multiple=32)
    ref = dense_counts(AD, DP, dtype=jnp.float64)
    return h, ref


@pytest.mark.parametrize("cap,kind,rtol", [(127, "int8", 1e-6),
                                           (PACK_MAX, "packed", 1e-4)])
def test_contractions_match_dense(heavy_data, cap, kind, rtol):
    h, ref = _hybrid(heavy_data, cap, kind)
    assert h.resid_nnz > 0
    rng = np.random.RandomState(0)
    W = jnp.asarray(rng.rand(ref.n_cell, 4))
    S1h, SSh = h.suff_stats(W)
    S1r, SSr = ref.suff_stats(W)
    np.testing.assert_allclose(np.asarray(S1h), np.asarray(S1r),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(np.asarray(SSh), np.asarray(SSr),
                               rtol=rtol, atol=rtol)

    Wa = jnp.asarray(rng.randn(ref.n_var, 4))
    Wd = jnp.asarray(rng.randn(ref.n_var, 4))
    scale = float(np.abs(np.asarray(ref.cell_loglik(Wa, Wd))).max())
    np.testing.assert_allclose(np.asarray(h.cell_loglik(Wa, Wd)),
                               np.asarray(ref.cell_loglik(Wa, Wd)),
                               rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("cap,kind", [(127, "int8"), (PACK_MAX, "packed")])
def test_reductions_exact(heavy_data, cap, kind):
    h, ref = _hybrid(heavy_data, cap, kind)
    np.testing.assert_allclose(float(h.binom_coeff_sum()),
                               float(ref.binom_coeff_sum()), rtol=1e-8)
    ah, dh = h.row_sums()
    ar, dr = ref.row_sums()
    np.testing.assert_allclose(np.asarray(ah, dtype=np.float64),
                               np.asarray(ar), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dh, dtype=np.float64),
                               np.asarray(dr), rtol=1e-8)
    np.testing.assert_array_equal(np.asarray(h.n_vars_per_cell()),
                                  np.asarray(ref.n_vars_per_cell()))


@pytest.mark.parametrize("cap,kind", [(127, "int8"), (PACK_MAX, "packed")])
def test_densify_exact(heavy_data, cap, kind):
    AD, DP = heavy_data
    h, _ = _hybrid(heavy_data, cap, kind)
    d = h.densify()
    np.testing.assert_allclose(np.asarray(d.ad), AD.toarray())
    np.testing.assert_allclose(np.asarray(d.dp), DP.toarray())


def test_ladder_selects_hybrid(heavy_data):
    AD, DP = heavy_data
    n_elems = AD.shape[0] * AD.shape[1]

    # f32 dense (8 bytes/entry-pair) over budget, int8 hybrid under it
    c = counts_from_scipy(AD, DP, max_dense_elems=10,
                          dense_budget=3 * n_elems)
    assert isinstance(c, HybridCounts)
    assert isinstance(c.base, DenseCounts)
    assert c.base.ad.dtype == jnp.int8

    # int8 hybrid (2 bytes) over budget, packed hybrid (1 byte) under
    c = counts_from_scipy(AD, DP, max_dense_elems=10,
                          dense_budget=1.5 * n_elems)
    assert isinstance(c, HybridCounts)
    assert isinstance(c.base, PackedCounts)

    # nothing dense fits: pure COO fallback
    c = counts_from_scipy(AD, DP, max_dense_elems=10, dense_budget=100)
    assert isinstance(c, SparseCounts)


def test_em_fit_parity(heavy_data):
    """A full fit_vb on int8-hybrid counts matches the dense-f32 fit
    from the same init (exact integer operands, same contraction
    shapes)."""
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors, fit_vb)
    AD, DP = heavy_data
    coo = sparse_counts(AD, DP, dtype=jnp.float32, pad_multiple=64)
    h = hybrid_from_coo(coo, 127, "int8", pad_multiple=32)
    d = dense_counts(AD, DP, dtype=jnp.float32)

    cfg = VireoConfig(n_var=d.n_var, n_cell=d.n_cell, n_donor=3)
    rng = np.random.RandomState(7)
    state = init_state(cfg, rng=rng, dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)

    res_h = fit_vb(h, state, priors, cfg, max_iter=30)
    res_d = fit_vb(d, state, priors, cfg, max_iter=30)
    np.testing.assert_allclose(float(res_h.elbo_final),
                               float(res_d.elbo_final), rtol=1e-4)
    id_h = np.asarray(res_h.state.id_prob)
    id_d = np.asarray(res_d.state.id_prob)
    conf = (id_h.max(1) > 0.9) & (id_d.max(1) > 0.9)
    np.testing.assert_array_equal(np.argmax(id_h[conf], 1),
                                  np.argmax(id_d[conf], 1))


def test_sharded_hybrid_parity(heavy_data):
    """counts_from_scipy under a cell sharding still selects the hybrid
    rung and its contractions match the unsharded values on the
    8-virtual-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vireo_tpu.parallel.mesh import make_mesh, CELL_AXIS

    AD, DP = heavy_data
    n_elems = AD.shape[0] * AD.shape[1]
    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(None, CELL_AXIS))

    c = counts_from_scipy(AD, DP, max_dense_elems=10,
                          dense_budget=3 * n_elems, sharding=sh)
    assert isinstance(c, HybridCounts)
    ref = dense_counts(AD, DP, dtype=jnp.float64)

    rng = np.random.RandomState(3)
    W = jnp.asarray(rng.rand(ref.n_cell, 4))
    S1h, SSh = jax.jit(lambda w: c.suff_stats(w))(W)
    S1r, SSr = ref.suff_stats(W)
    np.testing.assert_allclose(np.asarray(S1h), np.asarray(S1r),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(SSh), np.asarray(SSr),
                               rtol=1e-6, atol=1e-6)
    Wa = jnp.asarray(rng.randn(ref.n_var, 4))
    Wd = jnp.asarray(rng.randn(ref.n_var, 4))
    np.testing.assert_allclose(
        np.asarray(jax.jit(lambda a, b: c.cell_loglik(a, b))(Wa, Wd)),
        np.asarray(ref.cell_loglik(Wa, Wd)), rtol=1e-5, atol=1e-5)


def test_wrap_pads_uneven_cells_on_mesh(small_data):
    """vireo_wrap on an explicit mesh pads a non-divisible cell axis
    with zero-count cells and returns arrays at the true cell count
    (the reference's only capacity mechanism --cellRange requires the
    user to manage ranges manually, vireo.py:136-142)."""
    from vireo_tpu.engine.wrap import vireo_wrap
    from vireo_tpu.parallel.mesh import make_mesh

    AD, DP, donor = small_data          # 40 cells? -> slice to 37
    AD, DP = AD[:, :37], DP[:, :37]     # force C % 8 != 0
    res = vireo_wrap(AD, DP, n_donor=3, n_init=2, random_seed=1,
                     check_doublet=True, verbose=False,
                     mesh=make_mesh(8))
    assert res["ID_prob"].shape[0] == 37
    assert res["doublet_LLR"].shape[0] == 37
    np.testing.assert_allclose(
        res["ID_prob"].sum(1) + res["doublet_prob"].sum(1), 1.0,
        rtol=1e-4)


@pytest.mark.parametrize("cap,kind", [(127, "int8"), (PACK_MAX, "packed")])
def test_var_subset_matches_dense(heavy_data, cap, kind):
    """var_subset keeps contractions and the binomial correction exact
    without densifying the full matrix."""
    AD, DP = heavy_data
    h, _ = _hybrid(heavy_data, cap, kind)
    idx = np.array([0, 3, 5, 7, 11, 13, 30, 49])
    hs = h.var_subset(idx)
    ref = dense_counts(AD.toarray()[idx], DP.toarray()[idx],
                       dtype=jnp.float64)
    rng = np.random.RandomState(2)
    W = jnp.asarray(rng.rand(ref.n_cell, 4))
    S1h, SSh = hs.suff_stats(W)
    S1r, SSr = ref.suff_stats(W)
    np.testing.assert_allclose(np.asarray(S1h), np.asarray(S1r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(SSh), np.asarray(SSr),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(hs.binom_coeff_sum()),
                               float(ref.binom_coeff_sum()), rtol=1e-8)
    d = hs.densify()
    np.testing.assert_allclose(np.asarray(d.ad), AD.toarray()[idx])


def test_sharded_packed_hybrid_parity(heavy_data):
    """The mesh packed-hybrid rung (MeshPackedCounts nibble base +
    replicated overflow residual) compiles under jit and matches the
    f64 dense contraction on the 8-virtual-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vireo_tpu.parallel.mesh import make_mesh, CELL_AXIS
    from vireo_tpu.ops.packed import MeshPackedCounts

    AD, DP = heavy_data
    n_elems = AD.shape[0] * AD.shape[1]
    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(None, CELL_AXIS))

    c = counts_from_scipy(AD, DP, max_dense_elems=10,
                          dense_budget=1.5 * n_elems, sharding=sh)
    assert isinstance(c, HybridCounts)
    assert isinstance(c.base, MeshPackedCounts)
    ref = dense_counts(AD, DP, dtype=jnp.float64)

    rng = np.random.RandomState(4)
    W = jnp.asarray(rng.rand(ref.n_cell, 4), jnp.float32)
    S1h, SSh = jax.jit(lambda w: c.suff_stats(w))(W)
    S1r, SSr = ref.suff_stats(jnp.asarray(W, jnp.float64))
    np.testing.assert_allclose(np.asarray(S1h), np.asarray(S1r),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(SSh), np.asarray(SSr),
                               rtol=1e-4, atol=1e-3)
    Wa = jnp.asarray(rng.randn(ref.n_var, 4), jnp.float32)
    Wd = jnp.asarray(rng.randn(ref.n_var, 4), jnp.float32)
    got = np.asarray(jax.jit(lambda a, b: c.cell_loglik(a, b))(Wa, Wd))
    want = np.asarray(ref.cell_loglik(jnp.asarray(Wa, jnp.float64),
                                      jnp.asarray(Wd, jnp.float64)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(float(c.binom_coeff_sum()),
                               float(ref.binom_coeff_sum()), rtol=1e-5)


@pytest.fixture(scope="module")
def midscale_pool():
    """~1.3M-nnz pool (2500 x 3200, 4 donors) with a planted heavy
    tail: ~0.7% of nonzeros above the nibble cap (15), ~0.1% above the
    int8 cap (127) — the residual fractions the hybrid rung sees on
    real deep-coverage pools."""
    from vireo_tpu.sim.synth import synth_pool_counts
    from vireo_tpu.ops.counts import _host_union_triplets

    d = synth_pool_counts(n_var=2500, n_cell=3200, n_donor=4,
                          density=0.2, mean_extra_depth=3.0,
                          doublet_rate=0.0, seed=9)
    rows, cols, a, dv = _host_union_triplets(d["AD"], d["DP"])
    rng = np.random.RandomState(3)
    hot = rng.rand(len(dv)) < 0.006
    dv = dv + hot * rng.randint(20, 120, len(dv))
    vhot = rng.rand(len(dv)) < 0.001
    dv = dv + vhot * rng.randint(150, 500, len(dv))
    a = np.minimum(a + (hot | vhot) * rng.randint(0, 80, len(dv)), dv)
    shape = d["AD"].shape
    AD = sp.csc_matrix((a, (rows, cols)), shape=shape)
    DP = sp.csc_matrix((dv, (rows, cols)), shape=shape)
    assert DP.nnz > 1_000_000
    assert 0.001 < (dv > 15).mean() < 0.01      # nibble-cap residual
    assert 0.0001 < (dv > 127).mean() < 0.01    # int8-cap residual
    return AD, DP, d["donor"]


def test_midscale_ladder_bitmatch(midscale_pool):
    """Randomized mid-scale property test (VERDICT r3 item 7): at
    ~1.3M nnz with realistic residual fractions, the int8-hybrid and
    packed-hybrid layouts bit-match the f64 dense contraction, and
    full f64 fits from the same init produce IDENTICAL donor calls on
    every cell."""
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors, fit_vb)

    AD, DP, truth = midscale_pool
    coo = sparse_counts(AD, DP, dtype=jnp.float64)
    h8 = hybrid_from_coo(coo, 127, "int8")
    hp = hybrid_from_coo(coo, PACK_MAX, "packed")
    ref = dense_counts(AD, DP, dtype=jnp.float64)
    assert h8.resid_nnz > 0 and hp.resid_nnz > h8.resid_nnz

    # contraction bit-match vs the f64 dense reference
    rng = np.random.RandomState(0)
    W = jnp.asarray(rng.rand(ref.n_cell, 4))
    S1r, SSr = (np.asarray(x) for x in ref.suff_stats(W))
    scale = np.abs(S1r).max()
    for h, tol in [(h8, 1e-11), (hp, 1e-6)]:
        S1h, SSh = (np.asarray(x) for x in h.suff_stats(W))
        np.testing.assert_allclose(S1h, S1r, rtol=tol, atol=tol * scale)
        np.testing.assert_allclose(SSh, SSr, rtol=tol, atol=tol * scale)
        np.testing.assert_allclose(float(h.binom_coeff_sum()),
                                   float(ref.binom_coeff_sum()),
                                   rtol=1e-9)
    Wa = jnp.asarray(rng.randn(ref.n_var, 4))
    Wd = jnp.asarray(rng.randn(ref.n_var, 4))
    want = np.asarray(ref.cell_loglik(Wa, Wd))
    lscale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(h8.cell_loglik(Wa, Wd)), want,
                               rtol=1e-11, atol=1e-11 * lscale)
    np.testing.assert_allclose(np.asarray(hp.cell_loglik(Wa, Wd)), want,
                               rtol=1e-6, atol=1e-6 * lscale)

    # end-to-end: f64 fits from one init converge to identical calls
    cfg = VireoConfig(n_var=ref.n_var, n_cell=ref.n_cell, n_donor=4)
    state = init_state(cfg, rng=np.random.RandomState(7),
                       dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)
    fits = {name: fit_vb(c, state, priors, cfg, max_iter=200,
                         min_iter=20)
            for name, c in [("dense", ref), ("h8", h8), ("hp", hp)]}
    calls = {k: np.argmax(np.asarray(r.state.id_prob), 1)
             for k, r in fits.items()}
    np.testing.assert_array_equal(calls["h8"], calls["dense"])
    np.testing.assert_array_equal(calls["hp"], calls["dense"])
    np.testing.assert_allclose(float(fits["h8"].elbo_final),
                               float(fits["dense"].elbo_final),
                               rtol=1e-10)
    np.testing.assert_allclose(float(fits["hp"].elbo_final),
                               float(fits["dense"].elbo_final), rtol=1e-6)

    # and the calls recover the simulated truth
    from vireo_tpu.ops.matching import optimal_match
    id_d = np.asarray(fits["dense"].state.id_prob)
    _, perm = optimal_match(np.eye(4)[truth], id_d, axis=1)
    assert (np.argmax(id_d[:, perm], 1) == truth).mean() > 0.95


def test_wrap_places_prebuilt_hybrid_on_mesh(heavy_data):
    """A pre-built HybridCounts passed to vireo_wrap with an explicit
    mesh gets its base cell-sharded and residual replicated; the run
    completes and returns well-formed posteriors."""
    from vireo_tpu.engine.wrap import vireo_wrap
    from vireo_tpu.parallel.mesh import make_mesh

    AD, DP = heavy_data
    n_elems = AD.shape[0] * AD.shape[1]
    h = counts_from_scipy(AD, DP, max_dense_elems=10,
                          dense_budget=3 * n_elems)
    assert isinstance(h, HybridCounts)
    res = vireo_wrap(h, n_donor=3, n_init=2, random_seed=4,
                     check_doublet=True, verbose=False,
                     mesh=make_mesh(8))
    assert res["ID_prob"].shape == (AD.shape[1], 3)
    np.testing.assert_allclose(
        res["ID_prob"].sum(1) + res["doublet_prob"].sum(1), 1.0,
        rtol=1e-4)


@pytest.mark.parametrize("cap,kind", [(127, "int8"), (PACK_MAX, "packed")])
@pytest.mark.parametrize("start,stop", [(0, 8), (7, 24), (13, 39), (1, 40)])
def test_cell_slice_matches_dense(heavy_data, cap, kind, start, stop):
    """cell_slice slices base + residual without densifying the full
    matrix; values, contractions and the binomial correction stay
    exact (incl. odd packed-byte boundaries)."""
    AD, DP = heavy_data
    h, _ = _hybrid(heavy_data, cap, kind)
    hs = h.cell_slice(start, stop)
    ref = dense_counts(AD.toarray()[:, start:stop],
                       DP.toarray()[:, start:stop], dtype=jnp.float64)
    d = hs.densify()
    np.testing.assert_allclose(np.asarray(d.ad),
                               AD.toarray()[:, start:stop])
    np.testing.assert_allclose(np.asarray(d.dp),
                               DP.toarray()[:, start:stop])
    np.testing.assert_allclose(float(hs.binom_coeff_sum()),
                               float(ref.binom_coeff_sum()), rtol=1e-8)
    rng = np.random.RandomState(1)
    W = jnp.asarray(rng.rand(stop - start, 4))
    S1h, SSh = hs.suff_stats(W)
    S1r, SSr = ref.suff_stats(W)
    np.testing.assert_allclose(np.asarray(S1h), np.asarray(S1r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(SSh), np.asarray(SSr),
                               rtol=1e-4, atol=1e-4)
