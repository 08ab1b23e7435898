"""Model-selection sweep, checkpointing, and timing utilities."""

import pytest
import numpy as np
import jax.numpy as jnp

from vireo_tpu.engine.select import sweep_n_donor, sweep_n_clone
from vireo_tpu.utils import checkpoint as ckpt
from vireo_tpu.utils.timing import PhaseTimer, throughput
from vireo_tpu.models.vireo import VireoConfig, init_state, default_priors


def test_sweep_n_donor_finds_truth(small_data):
    AD, DP, donor = small_data
    res = sweep_n_donor(AD, DP, n_donor_list=(2, 3), n_init=5,
                        random_seed=3, dtype=jnp.float64, verbose=False)
    assert set(res) == {2, 3, "best"}
    assert res[2].shape == (5,)
    # planted structure has 3 donors: K=3 should dominate K=2
    assert res[3].max() > res[2].max()
    assert res["best"] == 3


def test_sweep_n_clone_runs(small_data):
    AD, DP, _ = small_data
    res = sweep_n_clone(AD, DP, n_clone_list=(2, 3), n_init=3,
                        random_seed=4, dtype=jnp.float64, verbose=False)
    assert res[2].shape == (3,)
    assert res["best"] in (2, 3)


def test_checkpoint_roundtrip(tmp_path):
    cfg = VireoConfig(n_var=10, n_cell=8, n_donor=2)
    rng = np.random.RandomState(0)
    state = init_state(cfg, rng=rng, dtype=jnp.float64)
    priors = default_priors(cfg, dtype=jnp.float64)

    d = str(tmp_path)
    ckpt.save_state(d, 3, state, priors, elbo_trace=np.arange(5.0),
                    extra={"seed": 42})
    ckpt.save_state(d, 7, state, priors)
    assert ckpt.latest_step(d) == 7

    st, pr, extras = ckpt.load_state(d, step=3, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(st.id_prob),
                               np.asarray(state.id_prob))
    np.testing.assert_allclose(np.asarray(pr.gt_log),
                               np.asarray(priors.gt_log))
    np.testing.assert_array_equal(extras["elbo_trace"], np.arange(5.0))
    assert int(extras["seed"]) == 42


def test_rng_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path)
    np.random.seed(5)
    np.random.rand(3)
    ckpt.save_rng(d)
    a = np.random.rand(4)
    ckpt.load_rng(d)
    b = np.random.rand(4)
    np.testing.assert_array_equal(a, b)


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("load"):
        pass
    with t.phase("fit"):
        pass
    with t.phase("fit"):
        pass
    s = t.summary()
    assert "load" in s and "fit" in s
    tp = throughput(10, 100, 2.0)
    assert tp["em_iters_per_s"] == 5.0
    assert tp["cell_iters_per_s"] == 500.0


def test_reference_import_path_aliases():
    """Scripts written against vireoSNP.utils.* port by renaming the
    package only (vireoSNP/__init__.py + utils/ layout)."""
    from vireo_tpu.utils.vireo_model import Vireo
    from vireo_tpu.utils.bmm_model import BinomMixtureVB
    from vireo_tpu.utils.vireo_bulk import VireoBulk, LikRatio_test
    from vireo_tpu.utils.vireo_wrap import vireo_wrap
    from vireo_tpu.utils.vireo_doublet import predict_doublet
    from vireo_tpu.utils.vcf_utils import load_VCF, parse_donor_GPb
    from vireo_tpu.utils.io_utils import read_cellSNP, write_donor_id
    from vireo_tpu.utils.vireo_base import normalize, optimal_match
    from vireo_tpu.utils.base_utils import get_confusion
    from vireo_tpu.utils.variant_select import variant_select
    for obj in (Vireo, BinomMixtureVB, VireoBulk, LikRatio_test,
                vireo_wrap, predict_doublet, load_VCF, parse_donor_GPb,
                read_cellSNP, write_donor_id, normalize, optimal_match,
                get_confusion, variant_select):
        assert callable(obj)


def test_bulk_parity_vs_reference(reference):
    """VireoBulk EM (device while_loop) matches the reference host EM:
    same psi/theta trajectory and LR test (vireo_bulk.py:44-167)."""
    import sys
    sys.path.insert(0, "/root/reference")
    from vireoSNP.utils.vireo_bulk import (VireoBulk as RefBulk,
                                           LikRatio_test as ref_LR)
    from vireo_tpu.models.bulk import VireoBulk, LikRatio_test

    rng = np.random.RandomState(4)
    n_var, K, G = 80, 3, 3
    GT_prob = rng.dirichlet([1.0] * G, size=(n_var, K))
    psi_true = np.array([0.6, 0.3, 0.1])
    theta = np.array([0.01, 0.5, 0.99])
    rate = (GT_prob @ theta) @ psi_true
    DP = rng.poisson(60, size=n_var) + 1
    AD = rng.binomial(DP, rate)

    np.random.seed(42)  # psi init draws from the global stream
    ref = RefBulk(n_donor=K)
    ref.fit(AD.astype(float), DP.astype(float), GT_prob)
    np.random.seed(42)
    ours = VireoBulk(n_donor=K)
    ours.fit(AD, DP, GT_prob)

    np.testing.assert_allclose(ours.psi, ref.psi, rtol=1e-8)
    np.testing.assert_allclose(ours.theta, np.asarray(ref.theta, float),
                               rtol=1e-8)
    np.testing.assert_allclose(ours.logLik, ref.logLik, rtol=1e-10)
    assert len(ours.logLik_all) == len(ref.logLik_all)

    psi_null = np.ones(K) / K
    lr_o, p_o = LikRatio_test(ours.psi, psi_null, AD, DP, GT_prob,
                              ours.theta)
    lr_r, p_r = ref_LR(ref.psi, psi_null, AD.astype(float),
                       DP.astype(float), GT_prob,
                       np.asarray(ref.theta, float))
    np.testing.assert_allclose(lr_o, lr_r, rtol=1e-8)
    np.testing.assert_allclose(p_o, p_r, rtol=1e-6)


def test_host_fetch_single_process_noop():
    """host_fetch is np.asarray for fully addressable arrays (the
    multi-process all-gather branch is exercised by
    benchmarks/multihost_wrap_demo.py)."""
    import jax.numpy as jnp
    from vireo_tpu.utils.fetch import host_fetch
    x = jnp.arange(6.0).reshape(2, 3)
    out = host_fetch(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(host_fetch(np.ones(3)), np.ones(3))


def test_vireo_profile_env_captures_trace(tmp_path, monkeypatch,
                                          small_data):
    """VIREO_PROFILE=<dir> wraps the orchestrator in a JAX profiler
    trace; the directory gains a trace artifact."""
    from vireo_tpu.engine.wrap import vireo_wrap
    import os
    AD, DP, _ = small_data
    trace_dir = str(tmp_path / "trace")
    monkeypatch.setenv("VIREO_PROFILE", trace_dir)
    vireo_wrap(AD, DP, n_donor=3, n_init=2, random_seed=1,
               check_doublet=False, verbose=False, mesh=None)
    found = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir)
             for f in fs]
    assert found, "no profiler artifacts written"


@pytest.mark.parametrize("env_dir", [None, "/tmp/jax_cache_from_env"])
def test_compile_cache_default(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX and nothing
    else is set; unset, the cache goes to <checkout>/.jax_cache."""
    import os
    import jax
    from vireo_tpu.utils import platform as P
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert P.DEFAULT_CACHE_DIR == os.path.join(checkout, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert P.apply_compile_cache() == P.DEFAULT_CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == \
                P.DEFAULT_CACHE_DIR
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
            assert P.apply_compile_cache() is None
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_host_fetch_parallel_exact(monkeypatch):
    """Concurrent chunked fetch returns exactly np.asarray's value for
    assorted shapes/dtypes; small and scalar inputs take the plain
    path."""
    import jax.numpy as jnp
    from vireo_tpu.utils import fetch as F
    monkeypatch.setattr(F, "_MIN_PARALLEL_BYTES", 64)  # force chunking
    rng = np.random.RandomState(0)
    for shape, dtype in [((1003, 7), np.float32), ((57,), np.float64),
                         ((9, 4, 3), np.float32), ((4, 2), np.int8)]:
        h = (rng.rand(*shape) * 100).astype(dtype)
        x = jnp.asarray(h)
        np.testing.assert_array_equal(F.host_fetch(x), h)
    assert F.host_fetch(jnp.asarray(3.5)) == np.float32(3.5)
    assert F.host_fetch(np.arange(5)).tolist() == [0, 1, 2, 3, 4]
    monkeypatch.setenv("VIREO_FETCH_STREAMS", "0")
    x = jnp.asarray(rng.rand(100, 5))
    np.testing.assert_array_equal(F.host_fetch(x), np.asarray(x))


def test_host_put_roundtrip(monkeypatch):
    """host_put (concurrent upload streams) is value- and dtype-
    equivalent to jnp.asarray for 1-D/2-D arrays, small arrays, and
    the disabled path."""
    import numpy as np
    import jax.numpy as jnp
    from vireo_tpu.utils import fetch as F

    rng = np.random.RandomState(0)
    big = rng.randint(0, 127, size=(5 << 20,)).astype(np.int8)
    mat = rng.rand(4096, 640)
    small = rng.rand(7)

    for x, dtype in ((big, None), (big, jnp.int8), (mat, jnp.float32),
                     (mat, None), (small, None)):
        got = F.host_put(x, dtype)
        want = jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    monkeypatch.setenv("VIREO_PUT_STREAMS", "1")
    got = F.host_put(big)
    np.testing.assert_array_equal(np.asarray(got), big)
