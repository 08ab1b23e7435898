"""Cell-sharded EM over a virtual 8-device mesh vs single-device fit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vireo_tpu.ops.counts import dense_counts
from vireo_tpu.models.vireo import (VireoConfig, init_state, default_priors,
                                    fit_vb)
from vireo_tpu.parallel.mesh import (make_mesh, build_cell_sharded_coo,
                                     sharded_fit_vb, fit_vb_auto)

N_DEV = 8


@pytest.fixture()
def sharded_setup(small_data):
    AD, DP, _ = small_data
    arrays, meta = build_cell_sharded_coo(AD, DP, n_shards=N_DEV,
                                          dtype=np.float64, pad_multiple=32)
    cfg = VireoConfig(n_var=meta["n_var"], n_cell=meta["n_cell_pad"],
                      n_donor=3)
    rng = np.random.RandomState(2)
    state = init_state(cfg, rng=rng, dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)
    return AD, DP, arrays, meta, cfg, state, priors


def test_sharded_matches_single_device(sharded_setup):
    AD, DP, arrays, meta, cfg, state, priors = sharded_setup
    mesh = make_mesh(N_DEV)

    res_sh = sharded_fit_vb(mesh, arrays, meta, state, priors, cfg,
                            max_iter=15, min_iter=3)

    n_cell = AD.shape[1]
    cfg1 = VireoConfig(n_var=AD.shape[0], n_cell=n_cell, n_donor=3)
    counts = dense_counts(AD, DP, dtype=jnp.float64)
    state1 = init_state(
        cfg1, ID_prob_init=np.asarray(state.id_prob)[:n_cell],
        GT_prob_init=np.asarray(state.gt_prob), dtype=jnp.float64)
    res_1 = fit_vb(counts, state1, priors, cfg1, max_iter=15, min_iter=3)

    np.testing.assert_allclose(float(res_sh.elbo_final),
                               float(res_1.elbo_final), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(res_sh.state.id_prob)[:n_cell],
        np.asarray(res_1.state.id_prob), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res_sh.state.gt_prob),
                               np.asarray(res_1.state.gt_prob),
                               rtol=1e-7, atol=1e-10)
    assert int(res_sh.n_iter) == int(res_1.n_iter)


def test_auto_sharded_dense(small_data):
    AD, DP, _ = small_data
    n_cell = AD.shape[1]
    mesh = make_mesh(N_DEV)
    cfg = VireoConfig(n_var=AD.shape[0], n_cell=n_cell, n_donor=3)
    counts = dense_counts(AD, DP, dtype=jnp.float64)
    rng = np.random.RandomState(2)
    state = init_state(cfg, rng=rng, dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)

    res_a = fit_vb_auto(mesh, counts, state, priors, cfg, max_iter=15,
                        min_iter=3)
    res_1 = fit_vb(counts, state, priors, cfg, max_iter=15, min_iter=3)
    np.testing.assert_allclose(float(res_a.elbo_final),
                               float(res_1.elbo_final), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(res_a.state.id_prob),
                               np.asarray(res_1.state.id_prob),
                               rtol=1e-7, atol=1e-10)


def test_warm_restarts_auto(small_data):
    from vireo_tpu.parallel.mesh import warm_restarts_auto
    AD, DP, _ = small_data
    mesh = make_mesh(N_DEV)
    cfg = VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=3)
    counts = dense_counts(AD, DP, dtype=jnp.float64)
    rng = np.random.RandomState(4)
    states = [init_state(cfg, rng=rng, dtype=jnp.float64)
              for _ in range(4)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    priors = default_priors(cfg, dtype=jnp.float64)

    res_sh = warm_restarts_auto(mesh, counts, batched, priors, cfg,
                                max_iter=10, min_iter=3)
    res_1 = jax.vmap(lambda st: fit_vb(counts, st, priors, cfg,
                                       max_iter=10, min_iter=3))(batched)
    np.testing.assert_allclose(np.asarray(res_sh.elbo_final),
                               np.asarray(res_1.elbo_final), rtol=1e-8)


def test_mesh2d_fit_parity(small_data):
    """2-D (vars x cells) capacity mesh: fit_vb_auto on a 2x4 grid
    reproduces the single-device fit (VERDICT r3 item 8 — the variant
    axis shards when n_var x n_cell_shard exceeds one chip's HBM)."""
    from vireo_tpu.parallel.mesh import make_mesh2d, VAR_AXIS, CELL_AXIS
    AD, DP, _ = small_data
    mesh = make_mesh2d(2, 4)
    assert dict(mesh.shape) == {VAR_AXIS: 2, CELL_AXIS: 4}
    cfg = VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=3)
    counts = dense_counts(AD, DP, dtype=jnp.float64)
    rng = np.random.RandomState(2)
    state = init_state(cfg, rng=rng, dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)

    res_a = fit_vb_auto(mesh, counts, state, priors, cfg, max_iter=15,
                        min_iter=3)
    res_1 = fit_vb(counts, state, priors, cfg, max_iter=15, min_iter=3)
    np.testing.assert_allclose(float(res_a.elbo_final),
                               float(res_1.elbo_final), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(res_a.state.id_prob),
                               np.asarray(res_1.state.id_prob),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res_a.state.gt_prob),
                               np.asarray(res_1.state.gt_prob),
                               rtol=1e-7, atol=1e-10)


def test_mesh2d_fit_parity_ase(small_data):
    """2-D mesh with ASE mode: the per-variant theta tables shard on
    the vars axis and the fit still matches single-device."""
    from vireo_tpu.parallel.mesh import make_mesh2d
    AD, DP, _ = small_data
    mesh = make_mesh2d(4, 2)
    cfg = VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=3,
                      ASE_mode=True)
    counts = dense_counts(AD, DP, dtype=jnp.float64)
    rng = np.random.RandomState(3)
    state = init_state(cfg, rng=rng, dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)
    res_a = fit_vb_auto(mesh, counts, state, priors, cfg, max_iter=10,
                        min_iter=3)
    res_1 = fit_vb(counts, state, priors, cfg, max_iter=10, min_iter=3)
    np.testing.assert_allclose(float(res_a.elbo_final),
                               float(res_1.elbo_final), rtol=1e-8)


def test_vireo_wrap_on_mesh2d(small_data):
    """Public wrap API with an explicit 2-D mesh (uneven cell count:
    pads to the CELL-axis shard count, not the device count): results
    equal the unsharded wrap."""
    from vireo_tpu.engine.wrap import vireo_wrap
    from vireo_tpu.parallel.mesh import make_mesh2d
    AD, DP, _ = small_data
    AD, DP = AD[:, :37], DP[:, :37]     # 37 % 4 != 0 -> padded
    mesh = make_mesh2d(2, 4)
    kw = dict(n_donor=3, learn_GT=True, n_init=3, random_seed=23,
              check_doublet=True, dtype=jnp.float64, verbose=False)
    res_m = vireo_wrap(AD, DP, mesh=mesh, **kw)
    res_1 = vireo_wrap(AD, DP, **kw)
    assert res_m["ID_prob"].shape[0] == 37
    np.testing.assert_allclose(res_m["ID_prob"], res_1["ID_prob"],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res_m["LB_doublet"], res_1["LB_doublet"],
                               rtol=1e-8)


def test_graft_entry_dryrun():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g
    g.dryrun_multichip(N_DEV)


def test_vireo_wrap_on_mesh(small_data):
    """Public wrap API with a mesh: results equal the unsharded wrap."""
    from vireo_tpu.engine.wrap import vireo_wrap
    AD, DP, _ = small_data
    mesh = make_mesh(N_DEV)
    kw = dict(n_donor=3, learn_GT=True, n_init=3, random_seed=23,
              check_doublet=True, dtype=jnp.float64, verbose=False)
    res_m = vireo_wrap(AD, DP, mesh=mesh, **kw)
    res_1 = vireo_wrap(AD, DP, **kw)
    np.testing.assert_allclose(res_m["ID_prob"], res_1["ID_prob"],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res_m["LB_doublet"], res_1["LB_doublet"],
                               rtol=1e-8)


def test_warm_restarts_sharded_restarts(small_data):
    """Restart-axis fan-out: data replicated, the restart batch split
    across devices; results match the cell-sharded layout."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vireo_tpu.parallel.mesh import make_mesh, warm_restarts_auto
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors)
    from vireo_tpu.ops.counts import dense_counts

    AD, DP, truth = small_data
    n_var, n_cell = AD.shape
    K, R = 3, 8
    cfg = VireoConfig(n_var=n_var, n_cell=n_cell, n_donor=K)
    counts = dense_counts(AD.toarray(), DP.toarray(), dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    states = [init_state(cfg, rng=rng, dtype=jnp.float32)
              for _ in range(R)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *states)

    mesh = make_mesh(n_devices=8)
    res_r = warm_restarts_auto(mesh, counts, batched, priors, cfg,
                               shard_axis="restarts",
                               min_iter=5, max_iter=10)
    res_c = warm_restarts_auto(mesh, counts, batched, priors, cfg,
                               shard_axis="cells",
                               min_iter=5, max_iter=10)
    np.testing.assert_allclose(np.asarray(res_r.elbo_ref),
                               np.asarray(res_c.elbo_ref), rtol=1e-4)


def test_sharded_loader_single_process():
    """Per-process cell-range loading (single-process degenerate case):
    the assembled DenseCounts equals the full read."""
    import numpy as np
    import jax.numpy as jnp
    from vireo_tpu.parallel.loader import (process_cell_range,
                                           load_cellSNP_sharded,
                                           dense_counts_from_local)
    from vireo_tpu.parallel.mesh import make_mesh
    from vireo_tpu.io.matrices import read_cellSNP

    lo, hi, c_local = process_cell_range(100, process_id=2, n_processes=3)
    assert (lo, hi, c_local) == (68, 100, 34)

    dat, meta = load_cellSNP_sharded("/root/reference/data/cellSNP_mat")
    full = read_cellSNP("/root/reference/data/cellSNP_mat")
    assert meta[:2] == (0, 952)
    assert (dat["AD"] != full["AD"]).nnz == 0

    mesh = make_mesh(n_devices=4)
    counts = dense_counts_from_local(mesh, dat["AD"], dat["DP"], meta)
    np.testing.assert_array_equal(
        np.asarray(counts.ad, np.int32),
        np.minimum(np.asarray(full["AD"].todense()), 127).astype(np.int32))


def test_wrap_auto_mesh_int8_end_to_end(monkeypatch):
    """The production path at scale: vireo_wrap(mesh="auto") builds a
    mesh over all local devices and runs the dense-int8 sharded layout;
    donor calls bit-match the single-device run of the SAME layout
    (VERDICT item 1 done-criterion)."""
    from vireo_tpu.sim.synth import synth_pool_counts
    from vireo_tpu.ops.counts import counts_from_scipy
    from vireo_tpu.engine.wrap import vireo_wrap, _resolve_mesh

    d = synth_pool_counts(n_var=200, n_cell=1600, n_donor=4,
                          doublet_rate=0.06, density=0.3,
                          mean_extra_depth=2.0, seed=5)
    monkeypatch.setenv("VIREO_MESH_MIN_CELLS", "64")
    mesh = _resolve_mesh("auto", 1600)
    assert mesh is not None and mesh.devices.size == N_DEV

    # same int8 device layout for both runs (the at-scale CLI choice)
    counts = counts_from_scipy(d["AD"], d["DP"], max_dense_elems=10)
    assert counts.ad.dtype == jnp.int8

    kw = dict(n_donor=4, learn_GT=True, n_init=4, random_seed=11,
              check_doublet=True, verbose=False)
    res_m = vireo_wrap(counts, mesh=mesh, **kw)
    res_1 = vireo_wrap(counts, mesh=None, **kw)

    # All restarts converge to the same optimum modulo donor-label
    # permutation with ELBOs tied within float noise, so the selected
    # labeling may legitimately differ under a different reduction
    # order; compare after Hungarian alignment (the reference's own
    # cross-run comparison, vireo_base.py:187-206).
    from vireo_tpu.ops.matching import optimal_match
    idx = optimal_match(res_1["GT_prob"], res_m["GT_prob"])[1]
    id_m = res_m["ID_prob"][:, idx]

    assert (np.argmax(id_m, 1) == np.argmax(res_1["ID_prob"], 1)).all()
    np.testing.assert_allclose(id_m, res_1["ID_prob"], atol=1e-3)
    np.testing.assert_allclose(res_m["LB_doublet"], res_1["LB_doublet"],
                               rtol=1e-6)
    np.testing.assert_allclose(res_m["doublet_LLR"], res_1["doublet_LLR"],
                               rtol=1e-3, atol=0.05)

    # truth recovery sanity on the mesh result
    calls = np.argmax(res_m["ID_prob"], 1)
    singlet = d["donor2"] < 0
    from scipy.optimize import linear_sum_assignment
    conf = np.zeros((4, 4))
    for t, c in zip(d["donor"][singlet], calls[singlet]):
        conf[t, c] += 1
    ri, ci = linear_sum_assignment(-conf)
    assert conf[ri, ci].sum() / singlet.sum() > 0.95


def test_resolve_mesh_gates(monkeypatch):
    from vireo_tpu.engine.wrap import _resolve_mesh
    monkeypatch.setenv("VIREO_MESH_MIN_CELLS", "1000")
    assert _resolve_mesh("auto", 500) is None          # too small
    assert _resolve_mesh("auto", 2000) is not None     # big enough
    assert _resolve_mesh(None, 2000) is None           # explicit off
    monkeypatch.setenv("VIREO_MESH", "off")
    assert _resolve_mesh("auto", 2000) is None         # env kill switch


def test_mesh_packed_parity(small_data):
    """The nibble-packed capacity rung on an 8-device mesh: densify
    roundtrip + full EM parity vs the single-device packed layout
    (VERDICT round-2 item 4 done-criterion)."""
    import scipy.sparse as sp
    from vireo_tpu.ops.packed import (pack_dense, pack_scipy_sharded,
                                      MeshPackedCounts)

    AD, DP, _ = small_data
    DPd = np.minimum(np.asarray(DP.todense()), 15.0)
    ADd = np.minimum(np.asarray(AD.todense()), DPd)
    mesh = make_mesh(N_DEV)
    mp = pack_scipy_sharded(sp.csr_matrix(ADd), sp.csr_matrix(DPd), mesh)
    assert isinstance(mp, MeshPackedCounts)

    d = mp.densify()
    np.testing.assert_array_equal(np.asarray(d.ad), ADd)
    np.testing.assert_array_equal(np.asarray(d.dp), DPd)

    single = pack_dense(ADd, DPd)
    np.testing.assert_allclose(float(mp.binom_coeff_sum()),
                               float(single.binom_coeff_sum()), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(mp.n_vars_per_cell()),
                                  np.asarray(single.n_vars_per_cell()))
    a_m, d_m = mp.row_sums()
    a_s, d_s = single.row_sums()
    np.testing.assert_allclose(np.asarray(a_m), np.asarray(a_s))
    np.testing.assert_allclose(np.asarray(d_m), np.asarray(d_s))

    cfg = VireoConfig(n_var=ADd.shape[0], n_cell=ADd.shape[1], n_donor=3)
    rng = np.random.RandomState(4)
    state = init_state(cfg, rng=rng, dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)
    res_m = fit_vb(mp, state, priors, cfg, max_iter=15, min_iter=3)
    res_s = fit_vb(single, state, priors, cfg, max_iter=15, min_iter=3)
    np.testing.assert_allclose(float(res_m.elbo_final),
                               float(res_s.elbo_final), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res_m.state.id_prob),
                               np.asarray(res_s.state.id_prob),
                               rtol=1e-3, atol=1e-4)

    sub = mp.var_subset(np.array([2, 0, 7]))
    dsub = sub.densify()
    np.testing.assert_array_equal(np.asarray(dsub.ad), ADd[[2, 0, 7]])


def test_counts_from_scipy_packed_on_mesh(small_data):
    """The ladder's packed rung engages under a mesh sharding."""
    import scipy.sparse as sp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vireo_tpu.ops.counts import counts_from_scipy
    from vireo_tpu.ops.packed import MeshPackedCounts
    from vireo_tpu.parallel.mesh import CELL_AXIS

    AD, DP, _ = small_data
    DPd = np.minimum(np.asarray(DP.todense()), 15.0)
    ADd = np.minimum(np.asarray(AD.todense()), DPd)
    ADs, DPs = sp.csr_matrix(ADd), sp.csr_matrix(DPd)
    mesh = make_mesh(N_DEV)
    sh = NamedSharding(mesh, P(None, CELL_AXIS))
    n = ADd.size
    c = counts_from_scipy(ADs, DPs, max_dense_elems=0,
                          dense_budget=1.5 * n, sharding=sh)
    assert isinstance(c, MeshPackedCounts)
    got = c.densify()
    np.testing.assert_array_equal(np.asarray(got.ad), ADd)


def test_vireo_wrap_on_mesh_packed():
    """Full orchestrator (warm restarts -> refit -> doublet) on a
    MeshPackedCounts: restarts vmap over the shard_mapped kernels; the
    result matches the single-device packed run up to donor label
    switching and both recover the simulated truth."""
    import scipy.sparse as sp
    from vireo_tpu.sim.synth import synth_pool_counts
    from vireo_tpu.ops.packed import pack_scipy_sharded, pack_dense
    from vireo_tpu.ops.matching import optimal_match
    from vireo_tpu.engine.wrap import vireo_wrap

    pool = synth_pool_counts(n_var=300, n_cell=500, n_donor=3,
                             density=0.2, seed=1)
    DPd = np.minimum(np.asarray(pool["DP"].todense()), 15.0)
    ADd = np.minimum(np.asarray(pool["AD"].todense()), DPd)
    mesh = make_mesh(N_DEV)
    mp = pack_scipy_sharded(sp.csr_matrix(ADd), sp.csr_matrix(DPd), mesh)

    kw = dict(n_donor=3, learn_GT=True, n_init=3, random_seed=7,
              check_doublet=True, dtype=jnp.float32, verbose=False,
              mesh=None)
    res_m = vireo_wrap(mp, **kw)
    res_s = vireo_wrap(pack_dense(ADd, DPd), **kw)

    np.testing.assert_allclose(res_m["LB_doublet"], res_s["LB_doublet"],
                               rtol=1e-5)
    _, perm = optimal_match(res_s["GT_prob"], res_m["GT_prob"], axis=1)
    np.testing.assert_array_equal(
        np.argmax(res_m["ID_prob"][:, perm], 1),
        np.argmax(res_s["ID_prob"], 1))
    truth = pool["donor"]
    _, t_perm = optimal_match(np.eye(3)[truth], res_m["ID_prob"], axis=1)
    acc = (np.argmax(res_m["ID_prob"][:, t_perm], 1) == truth).mean()
    assert acc > 0.98


def test_dense_sharded_matches_single_device(small_data):
    """The multi-process DENSE path (shard_map over per-shard dense
    blocks, psum'd variant statistics) reproduces the single-device
    fit — same contract as the COO path, as dense matrix products."""
    from vireo_tpu.parallel.mesh import (build_cell_sharded_dense,
                                         sharded_fit_vb_dense)
    AD, DP, _ = small_data
    ad, dp, meta = build_cell_sharded_dense(AD, DP, N_DEV,
                                            dtype=np.float64)
    cfg = VireoConfig(n_var=meta["n_var"], n_cell=meta["n_cell_pad"],
                      n_donor=3)
    rng = np.random.RandomState(2)
    state = init_state(cfg, rng=rng, dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)
    mesh = make_mesh(N_DEV)

    res_sh = sharded_fit_vb_dense(mesh, ad, dp, meta, state, priors,
                                  cfg, max_iter=15, min_iter=3)

    n_cell = AD.shape[1]
    cfg1 = VireoConfig(n_var=AD.shape[0], n_cell=n_cell, n_donor=3)
    counts = dense_counts(AD, DP, dtype=jnp.float64)
    state1 = init_state(
        cfg1, ID_prob_init=np.asarray(state.id_prob)[:n_cell],
        GT_prob_init=np.asarray(state.gt_prob), dtype=jnp.float64)
    res_1 = fit_vb(counts, state1, priors, cfg1, max_iter=15, min_iter=3)

    np.testing.assert_allclose(float(res_sh.elbo_final),
                               float(res_1.elbo_final), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(res_sh.state.id_prob)[:n_cell],
        np.asarray(res_1.state.id_prob), rtol=1e-7, atol=1e-10)


def test_ladder_budget_aggregates_across_mesh(small_data, monkeypatch):
    """On a mesh, the dense ladder sizes against the AGGREGATE HBM of
    the chips the sharding spans — an n-chip pool holds n times more
    per rung. (Explicit dense_budget stays a total.)"""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vireo_tpu.ops import counts as CT
    from vireo_tpu.ops.counts import counts_from_scipy, DenseCounts
    from vireo_tpu.parallel.mesh import CELL_AXIS

    AD, DP, _ = small_data
    n = AD.shape[0] * AD.shape[1]
    mesh = make_mesh(N_DEV)
    sh = NamedSharding(mesh, P(None, CELL_AXIS))
    assert CT._shard_factor(sh) == N_DEV
    assert CT._shard_factor(None) == 1

    # per-chip budget too small for exact f32 dense (8 B/pair), but the
    # 8-chip aggregate fits: the sharded build picks the dense rung,
    # the single-device build falls down the ladder
    monkeypatch.setattr(CT, "device_dense_budget", lambda: 1.5 * n)
    c_mesh = counts_from_scipy(AD, DP, max_dense_elems=10, sharding=sh)
    assert isinstance(c_mesh, DenseCounts)
    c_one = counts_from_scipy(AD, DP, max_dense_elems=10)
    assert not isinstance(c_one, DenseCounts)


def test_resolve_mesh_shape_env(monkeypatch):
    """VIREO_MESH_SHAPE=2x4 makes mesh='auto' build the 2-D capacity
    mesh."""
    from vireo_tpu.engine.wrap import _resolve_mesh
    from vireo_tpu.parallel.mesh import VAR_AXIS, CELL_AXIS
    monkeypatch.setenv("VIREO_MESH_MIN_CELLS", "100")
    monkeypatch.setenv("VIREO_MESH_SHAPE", "2x4")
    mesh = _resolve_mesh("auto", 1000)
    assert dict(mesh.shape) == {VAR_AXIS: 2, CELL_AXIS: 4}


def test_auto_mesh_elects_2d_when_var_state_busts_budget(small_data,
                                                         monkeypatch):
    """mesh="auto" election (VERDICT r4 #4): when the per-chip count
    shard plus the 1-D-replicated variant-axis state exceeds the HBM
    budget but sharding variants 2 ways fits, _resolve_mesh builds the
    2-D vars x cells mesh automatically; the ladder stays dense and
    the wrap result matches the single-device run."""
    import scipy.sparse as sp
    from vireo_tpu.engine.wrap import vireo_wrap, _resolve_mesh
    from vireo_tpu.engine import wrap as wrapmod
    from vireo_tpu.parallel.mesh import VAR_AXIS, CELL_AXIS
    from vireo_tpu.sim.synth import synth_pool_counts

    pool = synth_pool_counts(n_var=512, n_cell=128, n_donor=4,
                             density=0.4, mean_extra_depth=2.0, seed=5)
    AD, DP = pool["AD"], pool["DP"]

    monkeypatch.setenv("VIREO_MESH_MIN_CELLS", "64")
    # per-chip budget 0.5 MiB: 1-D needs count/8 + (16+2)*512*4*3*8 B
    # (f64 warm gt batch) ~ 0.86 MiB -> fails; vars 2-way fits
    monkeypatch.setenv("VIREO_DENSE_BUDGET_GB", repr(0.5 / 1024))

    elected = {}
    orig = wrapmod._resolve_mesh

    def spy(mesh, n_cell, **kw):
        m = orig(mesh, n_cell, **kw)
        elected["mesh"] = m
        return m

    monkeypatch.setattr(wrapmod, "_resolve_mesh", spy)
    kw = dict(n_donor=4, learn_GT=True, n_init=16, random_seed=17,
              check_doublet=True, dtype=jnp.float64, verbose=False)
    res_m = vireo_wrap(AD, DP, mesh="auto", **kw)
    mesh = elected["mesh"]
    assert mesh is not None and dict(mesh.shape) == {VAR_AXIS: 2,
                                                     CELL_AXIS: 4}

    monkeypatch.delenv("VIREO_DENSE_BUDGET_GB")
    res_1 = vireo_wrap(AD, DP, mesh=None, **kw)
    np.testing.assert_allclose(res_m["ID_prob"], res_1["ID_prob"],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(res_m["LB_doublet"], res_1["LB_doublet"],
                               rtol=1e-8)

    # plenty of budget -> plain 1-D cells mesh (no election)
    monkeypatch.setenv("VIREO_DENSE_BUDGET_GB", "16")
    m = _resolve_mesh("auto", 128, count_bytes=1e6, var_state_bytes=1e6)
    assert m is not None and VAR_AXIS not in m.axis_names


def test_auto_mesh_hints_use_prior_donor_width(small_data):
    """A GT prior wider than n_donor widens the actual fit
    (vireo_wrap.py:111-119), so the 2-D-mesh election must size the
    variant state with the prior's donor count, not the requested one
    (round-5 review finding)."""
    from vireo_tpu.engine.wrap import _auto_mesh_hints
    AD, DP, _ = small_data
    gp = np.random.RandomState(0).rand(AD.shape[0], 16, 3)
    _, vs_prior = _auto_mesh_hints(AD, DP, 8, gp, 0, 10, 3, jnp.float32)
    _, vs_plain16 = _auto_mesh_hints(AD, DP, 16, None, 0, 10, 3,
                                     jnp.float32)
    _, vs_plain8 = _auto_mesh_hints(AD, DP, 8, None, 0, 10, 3,
                                    jnp.float32)
    assert vs_prior == vs_plain16
    assert vs_prior == 2 * vs_plain8
