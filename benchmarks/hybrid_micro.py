"""Hybrid (int8 base + overflow residual) EM iteration at the north
star with a heavy-tailed count distribution (max count >> 256).

This is the regime the exact dtype ladder cannot serve (f32 dense =
24 GB > HBM) and that previously fell through to the pure-COO fallback
(~0.8 s/iter). The hybrid rung should run at the int8 rung's
HBM-roofline speed plus a small residual-COO term.

Prints one JSON line. Usage: python benchmarks/hybrid_micro.py
Env: HY_VARS/HY_CELLS/HY_DONORS/HY_ITERS, HY_HOT (overflow fraction of
nonzeros, default 0.002).
"""

import json
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


def main():
    import scipy.sparse as sp
    from vireo_tpu.ops.counts import (counts_from_scipy, HybridCounts,
                                      sparse_counts)
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors, em_step)

    V = int(os.environ.get("HY_VARS", 30_000))
    C = int(os.environ.get("HY_CELLS", 100_000))
    K = int(os.environ.get("HY_DONORS", 16))
    iters = int(os.environ.get("HY_ITERS", 20))
    hot_frac = float(os.environ.get("HY_HOT", 0.002))
    density = 0.01

    rng = np.random.RandomState(0)
    nnz = int(V * C * density)
    rows = rng.randint(0, V, size=nnz)
    cols = rng.randint(0, C, size=nnz)
    dp = rng.poisson(3.0, size=nnz) + 1
    hot = rng.rand(nnz) < hot_frac
    dp = dp + hot * rng.randint(200, 2000, size=nnz)
    ad = rng.binomial(dp, 0.4)
    DP = sp.csr_matrix((dp.astype(np.float64), (rows, cols)),
                       shape=(V, C))
    AD = sp.csr_matrix((ad.astype(np.float64), (rows, cols)),
                       shape=(V, C))
    DP.sum_duplicates()
    AD.sum_duplicates()

    t0 = time.time()
    ladder_kwargs = {}
    if os.environ.get("HY_MAX_DENSE"):        # CPU smoke-size override
        ladder_kwargs["max_dense_elems"] = int(os.environ["HY_MAX_DENSE"])
    if os.environ.get("HY_BUDGET"):
        ladder_kwargs["dense_budget"] = float(os.environ["HY_BUDGET"])
    counts = counts_from_scipy(AD, DP, verbose=True, **ladder_kwargs)
    if not isinstance(counts, HybridCounts):
        print(json.dumps({"error": "ladder did not pick hybrid",
                          "got": type(counts).__name__}))
        return
    jax.block_until_ready(counts.base.ad)
    t_build = time.time() - t0

    cfg = VireoConfig(n_var=V, n_cell=C, n_donor=K)
    state = init_state(cfg, rng=np.random.RandomState(1),
                       dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)

    @jax.jit
    def run(counts, state):
        def body(i, st):
            st, _, _ = em_step(counts, st, priors, cfg,
                               update_theta=True)
            return st
        return jax.lax.fori_loop(0, iters, body, state)

    t0 = time.time()
    out = run(counts, state)
    jax.block_until_ready(out.id_prob)
    t_compile_and_first = time.time() - t0

    t0 = time.time()
    out = run(counts, state)
    jax.block_until_ready(out.id_prob)
    dt = (time.time() - t0) / iters

    resid_frac = counts.resid_nnz / nnz
    print("[hybrid] device=%s build=%.1fs first=%.1fs per_iter=%.2fms "
          "resid_nnz=%d (%.2f%% of nnz)"
          % (jax.devices()[0].device_kind, t_build, t_compile_and_first,
             1e3 * dt, counts.resid_nnz, 100 * resid_frac))
    print(json.dumps({
        "metric": "hybrid_em_iter_ms_%dx%dx%d" % (V, C, K),
        "value": round(1e3 * dt, 2), "unit": "ms/iter",
        "max_count": int(dp.max()), "resid_nnz": int(counts.resid_nnz),
        "resid_frac": round(resid_frac, 5),
        "build_s": round(t_build, 1)}))


if __name__ == "__main__":
    main()
