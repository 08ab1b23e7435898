"""Device-side numpy-legacy MT19937 stream (the seeded-parity killer).

Seeded runs must reproduce the reference's warm-start inits, which are
draws from the global ``np.random`` MT19937 stream
(/root/reference/vireoSNP/utils/vireo_wrap.py:52-54,
vireo_model.py:95-104). The host-parity path assembles those draws on
host and uploads them — ~240 MB of incompressible float32 at the
100k-cell scale.

This module regenerates the SAME stream on device from ~2.5 MB of
state:

- The host "plans" the stream: it advances ``np.random`` through the
  draws it owes (C-speed, ~1 s at 150M doubles — the expensive part
  was never the generation, it was the upload), capturing the raw
  624-word generator state every ``chunk`` doubles. Chunks are
  multiples of 312 doubles (= one 624-word twist block), so every lane
  starts at the same in-pool offset.
- The device runs D independent lanes: each tempers the tail of its
  captured pool, then ``lax.scan``s twist+temper rounds — the twist's
  in-place dependency structure splits into 4 vectorized sub-steps
  (new[i] needs new[i-227] for i >= 227 and new[0]/new[396] at
  i = 623), so one round is a handful of (D, 624) uint32 ops.
- Word pairs become doubles with numpy's exact transform
  ``((a >> 5) * 2^26 + (b >> 6)) / 2^53`` — exact in f64 (the integer
  has <= 53 bits and the divisor is a power of two), so with x64
  enabled the device stream is BIT-IDENTICAL to ``np.random.rand``.
  An f32 stream rounds the transform once (deterministic, ~1e-7
  relative), so the seeded init (`engine.wrap._mt_batched_init`) asks
  for f64 under a scoped x64 and casts only its normalized result.

``np_pairwise_sum_last`` mirrors numpy's pairwise summation order for
the per-restart normalizations so the x64 path reproduces the host
inits bit-for-bit end to end.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["plan_stream", "device_stream", "np_pairwise_sum_last"]

_N = 624
_M = 397
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)
_MAG = np.uint32(0x9908B0DF)


def plan_stream(n_total, rng=None, max_lanes=1024):
    """Advance the host generator by EXACTLY ``n_total`` ``rand()``
    draws, capturing per-lane start states.

    Returns a dict with ``states`` (D, 624) uint32, ``p0`` (in-pool
    word offset, identical for every lane), ``c_blocks`` (twist rounds
    per lane), ``chunk`` (doubles per lane) and ``n_total``. The host
    stream position afterwards equals a plain ``rng.rand(n_total)`` —
    later host draws (refit inits, ambient Dirichlet) stay
    stream-identical.
    """
    if rng is None:
        rng = np.random
    n_total = int(n_total)
    assert n_total > 0
    # chunk: multiple of 312 doubles (one whole twist block) so every
    # lane boundary lands at the same in-pool offset
    c_blocks = -(-n_total // (312 * max_lanes))
    chunk = 312 * c_blocks
    n_lanes = -(-n_total // chunk)

    states = np.empty((n_lanes, _N), np.uint32)
    p0 = None
    for i in range(n_lanes):
        name, keys, pos, _, _ = rng.get_state() \
            if hasattr(rng, "get_state") else np.random.get_state()
        assert name == "MT19937", "legacy MT19937 stream required"
        states[i] = keys
        if p0 is None:
            p0 = int(pos)
        else:
            assert int(pos) == p0, "lane offsets diverged"
        # advance: full chunk for every lane but the last, whose
        # device surplus is discarded — the HOST position must end at
        # exactly n_total consumed doubles
        todo = chunk if i < n_lanes - 1 else n_total - (n_lanes - 1) * chunk
        rng.rand(todo)
    return {"states": jnp.asarray(states), "p0": p0,
            "c_blocks": c_blocks, "chunk": chunk, "n_total": n_total}


def _twist(mt):
    """One MT19937 twist round over (D, 624) uint32, vectorized.

    The reference C loop updates in place; unrolling the dependency:
    new[i] reads old mt[i], old-or-new mt[i+1] (new only at i = 623)
    and mt[(i+397) % 624] — old for i < 227, new[i-227] after.
    """
    def tw(cur, nxt, far):
        y = (cur & _UPPER) | (nxt & _LOWER)
        return far ^ (y >> 1) ^ ((y & np.uint32(1)) * _MAG)

    nA = tw(mt[:, 0:227], mt[:, 1:228], mt[:, _M:_N])
    nB1 = tw(mt[:, 227:454], mt[:, 228:455], nA)
    nB2 = tw(mt[:, 454:623], mt[:, 455:624], nB1[:, 0:169])
    nlast = tw(mt[:, 623:624], nA[:, 0:1], nB1[:, 169:170])
    return jnp.concatenate([nA, nB1, nB2, nlast], axis=1)


def _temper(y):
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & np.uint32(0x9D2C5680))
    y = y ^ ((y << 15) & np.uint32(0xEFC60000))
    return y ^ (y >> 18)


def _words(states, p0, c_blocks):
    """Tempered word stream per lane: (D, 624 * c_blocks) uint32."""
    D = states.shape[0]
    head = _temper(states[:, p0:])            # remaining pool words

    def step(mt, _):
        mt = _twist(mt)
        return mt, _temper(mt)

    _, blocks = jax.lax.scan(step, states, None, length=c_blocks)
    full = jnp.concatenate(
        [head, jnp.moveaxis(blocks, 0, 1).reshape(D, c_blocks * _N)],
        axis=1)
    return full[:, :c_blocks * _N]


def device_stream(plan, dtype=None):
    """The ``rand()`` double stream of `plan` as ONE device array of
    shape (n_total,). f64 (bit-identical to numpy) when x64 is
    enabled, else f32 (single extra rounding, deterministic)."""
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 \
            else jnp.float32
    return _device_stream_jit(plan["states"], plan["p0"],
                              plan["c_blocks"], plan["n_total"],
                              jnp.dtype(dtype).name)


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _device_stream_jit(states, p0, c_blocks, n_total, dtype_name):
    dtype = jnp.dtype(dtype_name)
    w = _words(states, p0, c_blocks)          # (D, 624c)
    D = w.shape[0]
    # even/odd column slices of the word stream: words (2i, 2i+1)
    # make double i
    a = (w[:, 0::2] >> 5).astype(dtype)       # (D, 312c)
    b = (w[:, 1::2] >> 6).astype(dtype)
    vals = (a * dtype.type(67108864.0) + b) \
        / dtype.type(9007199254740992.0)
    return vals.reshape(D * 312 * c_blocks)[:n_total]


def np_pairwise_sum_last(x):
    """Sum over the last axis reproducing numpy's pairwise order for
    n <= 128 (loops_utils.h pairwise_sum): sequential below 8, else
    8 accumulators unrolled in steps of 8, combined as
    ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), sequential tail. Bit-matches
    ``np.sum(x, -1)`` for the K/G extents the inits use."""
    K = x.shape[-1]
    if K < 8:
        s = x[..., 0]
        for k in range(1, K):
            s = s + x[..., k]
        return s
    r = [x[..., j] for j in range(8)]
    i = 8
    while i + 8 <= K:
        for j in range(8):
            r[j] = r[j] + x[..., i + j]
        i += 8
    s = (((r[0] + r[1]) + (r[2] + r[3]))
         + ((r[4] + r[5]) + (r[6] + r[7])))
    while i < K:
        s = s + x[..., i]
        i += 1
    return s
