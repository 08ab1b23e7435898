"""PackedCounts (4-bit nibble layout) parity vs the dense backend.

The packed contractions are plain XLA: row blocks unpacked into the
int8 dense rung's operand, so they carry that rung's tolerance on a
device; the reductions (binom coeff, row sums, per-cell var counts)
are exact.
"""

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
import pytest

from vireo_tpu.ops.counts import (dense_counts, sparse_counts,
                                  counts_from_scipy, DenseCounts,
                                  SparseCounts)
from vireo_tpu.ops import counts as counts_mod
from vireo_tpu.ops.packed import PackedCounts, pack_dense, PACK_MAX


@pytest.fixture(scope="module")
def nibble_data():
    rng = np.random.RandomState(42)
    V, C = 37, 53                      # odd sizes exercise the padding
    DP = rng.binomial(1, 0.3, size=(V, C)) * rng.randint(1, 16, (V, C))
    AD = rng.binomial(DP, 0.4)
    assert DP.max() <= PACK_MAX
    return AD.astype(np.float64), DP.astype(np.float64)


def test_pack_dense_roundtrip(nibble_data):
    AD, DP = nibble_data
    p = pack_dense(AD, DP)
    d = p.densify()
    np.testing.assert_array_equal(np.asarray(d.ad), AD)
    np.testing.assert_array_equal(np.asarray(d.dp), DP)


def test_pack_from_coo_matches_pack_dense(nibble_data):
    AD, DP = nibble_data
    coo = sparse_counts(sp.csr_matrix(AD), sp.csr_matrix(DP),
                        pad_multiple=64)
    p1 = coo.pack()
    p2 = pack_dense(AD, DP)
    d1, d2 = p1.densify(), p2.densify()
    np.testing.assert_array_equal(np.asarray(d1.ad), np.asarray(d2.ad))
    np.testing.assert_array_equal(np.asarray(d1.dp), np.asarray(d2.dp))


def test_suff_stats_parity(nibble_data):
    AD, DP = nibble_data
    p = pack_dense(AD, DP)
    d = dense_counts(AD, DP, dtype=jnp.float64)
    rng = np.random.RandomState(0)
    W = jnp.asarray(rng.rand(d.n_cell, 5))
    S1p, SSp = p.suff_stats(W)
    S1d, SSd = d.suff_stats(W)
    np.testing.assert_allclose(np.asarray(S1p), np.asarray(S1d),
                               rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(np.asarray(SSp), np.asarray(SSd),
                               rtol=2e-2, atol=1e-2)


def test_cell_loglik_parity(nibble_data):
    AD, DP = nibble_data
    p = pack_dense(AD, DP)
    d = dense_counts(AD, DP, dtype=jnp.float64)
    rng = np.random.RandomState(1)
    Wa = jnp.asarray(rng.randn(d.n_var, 5))
    Wd = jnp.asarray(rng.randn(d.n_var, 5))
    got = np.asarray(p.cell_loglik(Wa, Wd))
    want = np.asarray(d.cell_loglik(Wa, Wd))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_reductions_exact(nibble_data):
    AD, DP = nibble_data
    p = pack_dense(AD, DP)
    d = dense_counts(AD, DP, dtype=jnp.float64)
    np.testing.assert_allclose(float(p.binom_coeff_sum()),
                               float(d.binom_coeff_sum()), rtol=1e-5)
    ap, dpp = p.row_sums()
    ad_, dd_ = d.row_sums()
    np.testing.assert_array_equal(np.asarray(ap), np.asarray(ad_))
    np.testing.assert_array_equal(np.asarray(dpp), np.asarray(dd_))
    np.testing.assert_array_equal(np.asarray(p.n_vars_per_cell()),
                                  np.asarray(d.n_vars_per_cell()))


def test_var_subset(nibble_data):
    AD, DP = nibble_data
    p = pack_dense(AD, DP)
    idx = np.array([3, 0, 11, 30, 7])
    sub = p.var_subset(idx)
    d = sub.densify()
    np.testing.assert_array_equal(np.asarray(d.ad), AD[idx])
    np.testing.assert_array_equal(np.asarray(d.dp), DP[idx])


def test_ladder_prefers_packed_when_int8_does_not_fit(nibble_data):
    AD, DP = nibble_data
    ADs, DPs = sp.csr_matrix(AD), sp.csr_matrix(DP)
    n = AD.size
    # budget fits packed (1 B/site over both matrices) but not int8 (2 B)
    c = counts_from_scipy(ADs, DPs, max_dense_elems=0,
                          dense_budget=1.5 * n)
    assert isinstance(c, PackedCounts)
    # budget fits int8 -> dense rung wins
    c = counts_from_scipy(ADs, DPs, max_dense_elems=0,
                          dense_budget=3 * n)
    assert isinstance(c, DenseCounts)
    # nothing fits -> COO
    c = counts_from_scipy(ADs, DPs, max_dense_elems=0, dense_budget=0)
    assert isinstance(c, SparseCounts)
    # counts beyond a nibble pack via the hybrid rung (clipped base +
    # overflow residual); plain packed only ever sees nibble counts
    from vireo_tpu.ops.counts import HybridCounts
    AD2 = AD.copy()
    AD2[0, 0] = 40.0
    DP2 = DP.copy()
    DP2[0, 0] = 50.0
    c = counts_from_scipy(sp.csr_matrix(AD2), sp.csr_matrix(DP2),
                          max_dense_elems=0, dense_budget=1.5 * n)
    assert isinstance(c, HybridCounts)
    assert isinstance(c.base, PackedCounts)
    # ... and pure COO with the hybrid rung disabled
    import os
    os.environ["VIREO_NO_HYBRID"] = "1"
    try:
        c = counts_from_scipy(sp.csr_matrix(AD2), sp.csr_matrix(DP2),
                              max_dense_elems=0, dense_budget=1.5 * n)
        assert isinstance(c, SparseCounts)
    finally:
        del os.environ["VIREO_NO_HYBRID"]


def test_em_fit_on_packed():
    """A full fit_vb on PackedCounts matches the dense result.

    The packed kernels reduce in a different summation order than one
    dense dot (even/odd cell split), so f32 trajectories can diverge on
    a weakly identified toy. A well-separated synthetic pool makes the
    optimum basin wide; comparison is permutation-matched and masked to
    confidently assigned cells, and both fits must recover the truth.
    """
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors, fit_vb)
    from vireo_tpu.ops.matching import optimal_match
    from vireo_tpu.sim.synth import synth_pool_counts

    pool = synth_pool_counts(n_var=400, n_cell=240, n_donor=3,
                             density=0.25, mean_extra_depth=1.0, seed=3)
    AD = np.asarray(pool["AD"].todense())
    DP = np.minimum(np.asarray(pool["DP"].todense()), PACK_MAX)
    AD = np.minimum(AD, DP)
    cfg = VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=3)
    rng = np.random.RandomState(7)
    state = init_state(cfg, rng=rng, dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)

    res_p = fit_vb(pack_dense(AD, DP), state, priors, cfg, max_iter=50)
    res_d = fit_vb(dense_counts(AD, DP, dtype=jnp.float32), state,
                   priors, cfg, max_iter=50)
    assert np.isfinite(float(res_p.elbo_final))
    np.testing.assert_allclose(float(res_p.elbo_final),
                               float(res_d.elbo_final), rtol=2e-3)

    id_p = np.asarray(res_p.state.id_prob)
    id_d = np.asarray(res_d.state.id_prob)
    # align packed donors to dense donors (label switching is allowed),
    # then compare hard calls on cells both fits are confident about
    idx0, idx1 = optimal_match(
        np.asarray(res_d.state.gt_prob), np.asarray(res_p.state.gt_prob),
        axis=1)
    id_p = id_p[:, idx1]
    conf = (id_p.max(1) > 0.9) & (id_d.max(1) > 0.9)
    assert conf.mean() > 0.9
    np.testing.assert_array_equal(np.argmax(id_p[conf], 1),
                                  np.argmax(id_d[conf], 1))
    # and both recover the simulated truth on those cells
    truth = pool["donor"]
    i0, i1 = optimal_match(
        np.eye(3)[truth], id_d, axis=1)
    acc = (np.argmax(id_d[conf][:, i1], 1) == truth[conf]).mean()
    assert acc > 0.95


@pytest.mark.parametrize("start,stop", [(0, 10), (3, 17), (4, 18), (5, 5)])
def test_packed_cell_slice_unpacks_byte_range(start, stop):
    """PackedCounts.cell_slice unpacks only the covering byte range;
    odd/even starts and stops all land on the right cells."""
    rng = np.random.RandomState(8)
    V, C = 24, 22
    dp = (rng.rand(V, C) < 0.6) * rng.randint(0, 16, (V, C))
    ad = np.minimum(rng.randint(0, 16, (V, C)), dp)
    pc = pack_dense(ad.astype(np.float64), dp.astype(np.float64))
    sl = pc.cell_slice(start, stop)
    np.testing.assert_array_equal(np.asarray(sl.ad), ad[:, start:stop])
    np.testing.assert_array_equal(np.asarray(sl.dp), dp[:, start:stop])


@pytest.mark.parametrize("n_cell", [7, 53])
@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("block_rows", [None, 4])
def test_xla_packed_contraction_matches_dense(monkeypatch, n_cell, K,
                                              block_rows):
    """Both packed contractions equal the f64 dense ones at odd cell
    counts, K=1 and K=16, unchunked and over 4-row blocks with a
    remainder block (37 rows)."""
    rng = np.random.RandomState(n_cell + K)
    V = 37
    DP = rng.binomial(1, 0.4, size=(V, n_cell)) * rng.randint(
        1, 16, (V, n_cell))
    AD = rng.binomial(DP, 0.4)
    if block_rows is not None:
        monkeypatch.setattr(counts_mod, "ROW_BLOCK_BYTES",
                            block_rows * -(-n_cell // 2))
    p = pack_dense(AD.astype(np.float64), DP.astype(np.float64))
    d = dense_counts(AD, DP, dtype=jnp.float64)
    W = jnp.asarray(rng.rand(n_cell, K))
    Wa = jnp.asarray(rng.randn(V, K))
    Wd = jnp.asarray(rng.randn(V, K))
    for got, want in zip(p.suff_stats(W) + (p.cell_loglik(Wa, Wd),),
                         d.suff_stats(W) + (d.cell_loglik(Wa, Wd),)):
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
