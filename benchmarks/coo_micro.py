"""Micro-benchmark of the COO contraction primitives on the device.

Isolates where the sparse EM iteration time goes at the north-star
sparsity (30M nnz, K=16): the W-row gather, the sorted segment-sum
scatter, and a cumsum+boundary-difference alternative that avoids
scatter entirely.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from vireo_tpu.utils.platform import apply_compile_cache  # noqa: E402

apply_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def timed(fn, *args, n=3):
    # a value fetch forces the device work to finish
    out = fn(*args)
    float(jnp.sum(out))
    best = np.inf
    for _ in range(n):
        t = time.time()
        float(jnp.sum(fn(*args)))
        best = min(best, time.time() - t)
    return best, out


def main():
    nnz = int(os.environ.get("MB_NNZ", 29_700_000))
    V = int(os.environ.get("MB_VARS", 30_000))
    C = int(os.environ.get("MB_CELLS", 100_000))
    K = 16
    rng = np.random.RandomState(0)
    rows = np.sort(rng.randint(0, V, size=nnz).astype(np.int32))
    cols = rng.randint(0, C, size=nnz).astype(np.int32)
    vals = rng.rand(nnz).astype(np.float32)
    row_ptr = np.searchsorted(rows, np.arange(V + 1)).astype(np.int32)

    rows_d = jnp.asarray(rows)
    cols_d = jnp.asarray(cols)
    vals_d = jnp.asarray(vals)
    ptr_d = jnp.asarray(row_ptr)
    W = jnp.asarray(rng.rand(C, K).astype(np.float32))

    @jax.jit
    def gather_only(cols_d, vals_d, W):
        x = jnp.take(W, cols_d, axis=0) * vals_d[:, None]
        return jnp.sum(x, axis=0)

    @jax.jit
    def seg_sum(rows_d, cols_d, vals_d, W):
        x = jnp.take(W, cols_d, axis=0) * vals_d[:, None]
        return jax.ops.segment_sum(x, rows_d, num_segments=V,
                                   indices_are_sorted=True)

    @jax.jit
    def seg_sum_unsorted_hint(rows_d, cols_d, vals_d, W):
        x = jnp.take(W, cols_d, axis=0) * vals_d[:, None]
        return jax.ops.segment_sum(x, rows_d, num_segments=V)

    BLOCK = 1 << 21

    @jax.jit
    def cumsum_bounds_blocked(ptr_d, cols_d, vals_d, W):
        """Per-block cumsum + boundary differences: segments are sorted,
        so S[v] = sum over blocks of (cs[hi_v]-cs[lo_v]) with the
        per-segment bounds clamped into each block."""
        n = cols_d.shape[0]
        n_blocks = n // BLOCK

        def body(i, acc):
            lo = i * BLOCK
            c = jax.lax.dynamic_slice_in_dim(cols_d, lo, BLOCK)
            v = jax.lax.dynamic_slice_in_dim(vals_d, lo, BLOCK)
            x = jnp.take(W, c, axis=0) * v[:, None]
            cs = jnp.cumsum(x, axis=0)
            cs0 = jnp.concatenate([jnp.zeros((1, K), cs.dtype), cs])
            b_lo = jnp.clip(ptr_d[:-1] - lo, 0, BLOCK)
            b_hi = jnp.clip(ptr_d[1:] - lo, 0, BLOCK)
            return acc + jnp.take(cs0, b_hi, axis=0) \
                - jnp.take(cs0, b_lo, axis=0)

        acc = jnp.zeros((V, K), jnp.float32)
        acc = jax.lax.fori_loop(0, n_blocks, body, acc)
        # remainder
        lo = n_blocks * BLOCK
        if n - lo:
            x = jnp.take(W, cols_d[lo:], axis=0) * vals_d[lo:, None]
            cs = jnp.cumsum(x, axis=0)
            cs0 = jnp.concatenate([jnp.zeros((1, K), cs.dtype), cs])
            b_lo = jnp.clip(ptr_d[:-1] - lo, 0, n - lo)
            b_hi = jnp.clip(ptr_d[1:] - lo, 0, n - lo)
            acc = acc + jnp.take(cs0, b_hi, axis=0) \
                - jnp.take(cs0, b_lo, axis=0)
        return acc

    print(f"device={jax.devices()[0]} nnz={nnz} K={K}", file=sys.stderr)
    t_g, _ = timed(gather_only, cols_d, vals_d, W)
    print(f"gather+mul only        : {t_g*1000:8.1f} ms", flush=True)
    t_s, s_ref = timed(seg_sum, rows_d, cols_d, vals_d, W)
    print(f"gather+segment_sum     : {t_s*1000:8.1f} ms", flush=True)
    t_u, _ = timed(seg_sum_unsorted_hint, rows_d, cols_d, vals_d, W)
    print(f"gather+segsum(no hint) : {t_u*1000:8.1f} ms", flush=True)
    t_c, s_cs = timed(cumsum_bounds_blocked, ptr_d, cols_d, vals_d, W)
    err = float(jnp.max(jnp.abs(s_ref - s_cs))
                / jnp.max(jnp.abs(s_ref)))
    print(f"cumsum+bounds(blocked) : {t_c*1000:8.1f} ms  "
          f"(rel err {err:.2e})", flush=True)


if __name__ == "__main__":
    main()
