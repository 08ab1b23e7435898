"""Benchmark: EM iterations/s of the dense int8 rung on a synthetic pool.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "iter/s"}
and, on stderr, the device it ran on (platform, device_kind, count, and
the card's name and power limit from nvidia-smi). Exits non-zero when
JAX finds no GPU: a host number is never reported under this metric.

Workload (BASELINE.json config 5): 30k variants x 100k cells x 16
donors, ~1% site density, generated on device as int8 dense counts.
Env: BENCH_CELLS, BENCH_VARS, BENCH_DONORS, BENCH_ITERS.
"""

import json
import os
import sys
import time

import numpy as np


def em_rate(n_var, n_cell, n_donor, n_iters, seed=1):
    """Iterations/s of the jitted EM loop (one compiled fori_loop with a
    traced trip count), best of three timed runs after a compile run."""
    import jax
    import jax.numpy as jnp
    from vireo_tpu.sim.synth import synth_pool_dense_device
    from vireo_tpu.ops.counts import device_dense_budget
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors, run_em_iters_n)

    need = 2 * n_var * n_cell
    if need > device_dense_budget():
        raise SystemExit("int8 dense counts (%.1f GiB) exceed the device "
                         "budget" % (need / 2**30))
    t0 = time.time()
    d = synth_pool_dense_device(n_var=n_var, n_cell=n_cell,
                                n_donor=n_donor, doublet_rate=0.08,
                                density=0.01, seed=0)
    counts = d["counts"]
    jax.block_until_ready(counts.ad)
    cfg = VireoConfig(n_var=n_var, n_cell=n_cell, n_donor=n_donor)
    state = init_state(cfg, rng=np.random.RandomState(seed),
                       dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)
    t_build = time.time() - t0

    def run(n):
        t0 = time.time()
        _, elbo = run_em_iters_n(counts, state, priors, cfg, n)
        e = float(jax.block_until_ready(elbo))
        return time.time() - t0, e

    t_compile, _ = run(1)
    runs = [run(n_iters) for _ in range(3)]
    per_iter = min(t for t, _ in runs) / n_iters
    print(f"[bench] layout=dense_int8 build={t_build:.1f}s "
          f"compile={t_compile:.1f}s per_iter={per_iter*1000:.3f}ms "
          f"elbo={runs[-1][1]:.1f}", file=sys.stderr)
    return 1.0 / per_iter


def main():
    from vireo_tpu.utils.platform import (apply_compile_cache, require_gpu,
                                          card_name_and_power_limit)
    apply_compile_cache()
    devs = require_gpu()
    print("[bench] device platform=%s kind=%s count=%d card=%s"
          % (devs[0].platform, devs[0].device_kind, len(devs),
             card_name_and_power_limit()), file=sys.stderr)

    n_cell = int(os.environ.get("BENCH_CELLS", 100_000))
    n_var = int(os.environ.get("BENCH_VARS", 30_000))
    n_donor = int(os.environ.get("BENCH_DONORS", 16))
    n_iters = int(os.environ.get("BENCH_ITERS", 30))
    rate = em_rate(n_var, n_cell, n_donor, n_iters)
    print(json.dumps({
        "metric": f"em_iters_per_s_{n_var//1000}kvar_x_"
                  f"{n_cell//1000}kcell_x_{n_donor}donor",
        "value": round(rate, 3),
        "unit": "iter/s",
    }))


if __name__ == "__main__":
    main()
