"""Device-side MT19937: bit parity with the numpy legacy stream and
with the host-assembled batched inits (VERDICT r4 #2 — the seeded-run
upload killer)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vireo_tpu.ops.mt19937 import (plan_stream, device_stream,
                                   np_pairwise_sum_last)


@pytest.mark.parametrize("seed,n,pre_words", [
    (2, 1000, 0),        # multi-lane, fresh seed (pos = 624)
    (7, 312 * 5, 0),     # exact chunk multiple
    (3, 987654, 0),      # large, uneven tail lane
    (3, 12345, 1),       # ODD in-pool offset (np.random.bytes(4))
    (11, 624 * 3 + 7, 3),
])
def test_stream_bit_parity_and_host_position(seed, n, pre_words):
    np.random.seed(seed)
    if pre_words:
        np.random.bytes(4 * pre_words)
    saved = np.random.get_state()
    want = np.random.rand(n)
    pos_want = np.random.get_state()

    np.random.set_state(saved)
    plan = plan_stream(n, max_lanes=7)
    got = np.asarray(device_stream(plan))
    pos_got = np.random.get_state()

    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the host generator ends at EXACTLY the same position
    assert pos_want[2] == pos_got[2]
    np.testing.assert_array_equal(pos_want[1], pos_got[1])


@pytest.mark.parametrize("K", [2, 3, 4, 7, 8, 12, 16, 24, 100, 128])
def test_pairwise_sum_matches_numpy_bitwise(K):
    x = np.random.RandomState(0).rand(50, K)
    np.testing.assert_array_equal(
        np.sum(x, axis=-1), np.asarray(np_pairwise_sum_last(jnp.asarray(x))))


@pytest.mark.parametrize("with_prior,n_cell_draw", [
    (False, None), (False, 30), (True, None)])
def test_mt_batched_init_bitmatches_host(small_data, with_prior,
                                         n_cell_draw):
    """_mt_batched_init reproduces _host_batched_init bit-for-bit
    (x64): same VireoState leaves, same np.random position after."""
    from vireo_tpu.engine.wrap import _host_batched_init, _mt_batched_init
    from vireo_tpu.models.vireo import VireoConfig

    cfg = VireoConfig(n_var=60, n_cell=40, n_donor=3)
    gp = None
    if with_prior:
        gp = np.random.RandomState(0).rand(60, 3, 3)

    np.random.seed(5)
    host = _host_batched_init(cfg, 4, gp, np.random, jnp.float64,
                              n_cell_draw=n_cell_draw)
    pos_host = np.random.get_state()

    np.random.seed(5)
    dev = _mt_batched_init(cfg, 4, gp, np.random, jnp.float64,
                           n_cell_draw=n_cell_draw)
    pos_dev = np.random.get_state()

    for name in ("beta_mu", "beta_sum", "gt_prob", "id_prob"):
        np.testing.assert_array_equal(
            np.asarray(getattr(host, name)),
            np.asarray(getattr(dev, name)), err_msg=name)
    assert pos_host[2] == pos_dev[2]
    np.testing.assert_array_equal(pos_host[1], pos_dev[1])


def test_wrap_seeded_device_mt_equals_host_path(small_data, monkeypatch):
    """vireo_wrap with VIREO_DEVICE_MT=1 reproduces the host-upload
    seeded run exactly (x64), including downstream host draws."""
    from vireo_tpu.engine.wrap import vireo_wrap

    AD, DP, _ = small_data
    kw = dict(n_donor=3, learn_GT=True, n_init=3, random_seed=6,
              check_doublet=True, dtype=jnp.float64, verbose=False,
              mesh=None)
    monkeypatch.setenv("VIREO_DEVICE_MT", "0")
    res_h = vireo_wrap(AD, DP, **kw)
    monkeypatch.setenv("VIREO_DEVICE_MT", "1")
    res_d = vireo_wrap(AD, DP, **kw)
    for key in ("ID_prob", "GT_prob", "doublet_prob", "LB_list"):
        np.testing.assert_array_equal(np.asarray(res_h[key]),
                                      np.asarray(res_d[key]),
                                      err_msg=key)


def test_float32_stream_is_deterministic_and_close():
    """The non-x64 f32 transform: deterministic and within
    ~1e-7 relative of the f64 stream."""
    np.random.seed(9)
    saved = np.random.get_state()
    plan = plan_stream(5000, max_lanes=4)
    f64 = np.asarray(device_stream(plan))
    np.random.set_state(saved)
    plan2 = plan_stream(5000, max_lanes=4)
    f32 = np.asarray(device_stream(plan2, dtype=jnp.float32))
    assert f32.dtype == np.float32
    np.testing.assert_allclose(f32, f64, rtol=2e-7, atol=2e-7)


def test_plan_stream_with_randomstate_object():
    """plan_stream works against a RandomState instance (not just the
    global np.random module) with the same bit parity and final
    position."""
    rng = np.random.RandomState(42)
    rng.rand(7)                      # arbitrary pre-consumption
    ref = np.random.RandomState(42)
    ref.rand(7)
    want = ref.rand(5000)

    plan = plan_stream(5000, rng=rng, max_lanes=5)
    got = np.asarray(device_stream(plan))
    np.testing.assert_array_equal(got, want)
    # both generators continue identically
    np.testing.assert_array_equal(rng.rand(10), ref.rand(10))
