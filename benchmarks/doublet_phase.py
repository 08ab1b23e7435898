"""Doublet-phase benchmark: the XLA path's time at the flagship size.

The doublet phase runs once per pipeline but touches the expanded
(K + C(K,2))-donor space: it makes three passes over the count
matrices (expanded E-step, then update_GT_prob's full em_step). A
single-pass kernel for this phase would have to beat the time printed
here.

Usage: python benchmarks/doublet_phase.py   (runs on the live backend;
BENCH_CELLS/BENCH_VARS/BENCH_DONORS override the workload)
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


def main():
    from vireo_tpu.sim.synth import synth_pool_dense_device
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors,
                                        updates_from_stats)
    from vireo_tpu.models.doublet import (add_doublet_GT,
                                          add_doublet_theta,
                                          _doublet_weights)
    from vireo_tpu.ops.math import softmax_from_loglik

    n_cell = int(os.environ.get("BENCH_CELLS", 100_000))
    n_var = int(os.environ.get("BENCH_VARS", 30_000))
    K = int(os.environ.get("BENCH_DONORS", 16))

    t0 = time.time()
    d = synth_pool_dense_device(n_var=n_var, n_cell=n_cell, n_donor=K,
                                doublet_rate=0.08, density=0.01, seed=0)
    counts = d["counts"]
    jax.block_until_ready(counts.ad)
    print(f"[doublet-bench] pool built in {time.time()-t0:.1f}s "
          f"dtype={counts.ad.dtype}", file=sys.stderr)

    cfg = VireoConfig(n_var=n_var, n_cell=n_cell, n_donor=K)
    rng = np.random.RandomState(1)
    state = init_state(cfg, rng=rng, dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)

    gt_both = add_doublet_GT(state.gt_prob)
    mu_both, sum_both = add_doublet_theta(state.beta_mu, state.beta_sum)
    K_exp = gt_both.shape[1]
    dr = min(0.5, n_cell / 100000)
    prior_both = jnp.log(jnp.concatenate([
        jnp.full((K,), (1.0 - dr) / K),
        jnp.full((K_exp - K,), dr / (K_exp - K))]).astype(jnp.float32))

    # ---- host path: expanded E-step + softmax + GT refresh (3 passes)
    @jax.jit
    def host_step(counts, gt_both, mu_both, sum_both, state):
        Wfa, Wfd = _doublet_weights(gt_both, mu_both, sum_both)
        ll = counts.cell_loglik(Wfa, Wfd)
        id_both = softmax_from_loglik(ll, prior_both[None, :])
        id_sing = id_both[:, :K]
        S1, SS = counts.suff_stats(id_sing)
        _, _, gt_prob, _, _ = updates_from_stats(
            S1, SS, state, priors, cfg, update_theta=False)
        llr = ll[:, K:].max(1) - ll[:, :K].max(1)
        return jnp.sum(gt_prob) + jnp.sum(llr) + jnp.sum(id_sing)

    def bench(fn, args, n=5):
        out = fn(*args)  # compile
        jax.block_until_ready(out)
        best = np.inf
        for _ in range(n):
            t = time.time()
            jax.block_until_ready(fn(*args))
            best = min(best, time.time() - t)
        return best, float(out)

    t_host, c_host = bench(host_step,
                           (counts, gt_both, mu_both, sum_both, state))
    print(f"[doublet-bench] device={jax.devices()[0]} K_exp={K_exp}",
          file=sys.stderr)
    print(f"[doublet-bench] host  path: {t_host*1000:.1f} ms "
          f"(checksum {c_host:.4g})", file=sys.stderr)
    import json
    print(json.dumps({
        "metric": f"doublet_phase_ms_{n_var//1000}kvar_x_"
                  f"{n_cell//1000}kcell_x_{K}donor",
        "value": t_host * 1000,
        "unit": "ms",
    }))


if __name__ == "__main__":
    main()
