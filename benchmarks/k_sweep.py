"""North-star K-sweep: ELBO model selection over candidate donor
counts on the 30k x 100k pool, through `sweep_n_donor` (the notebook
recipe doc/index.rst:52-53 as a first-class API).

The sweep shares ONE device data layout across every K, and the
restart inits come from the wrap's batched-init machinery: unseeded
runs draw them on device (zero init upload per K — the round-4 review
flagged the per-restart host-init path, which would have paid a
~250 MB upload per K at this scale); seeded runs regenerate the exact
np.random stream on device (ops/mt19937.py). Prints one JSON line.

Usage: python benchmarks/k_sweep.py          (GPU)
       KSWEEP_KS=8,12,16 KSWEEP_INIT=8 ...   (override the grid)
       JAX_PLATFORMS=cpu KSWEEP_VARS=2000 KSWEEP_CELLS=4000 (smoke)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from vireo_tpu.utils.platform import apply_compile_cache
    apply_compile_cache()
    import jax

    from vireo_tpu.sim.synth import synth_pool_dense_device
    from vireo_tpu.engine.select import sweep_n_donor

    n_var = int(os.environ.get("KSWEEP_VARS", 30_000))
    n_cell = int(os.environ.get("KSWEEP_CELLS", 100_000))
    n_donor = int(os.environ.get("KSWEEP_DONORS", 16))
    n_init = int(os.environ.get("KSWEEP_INIT", 8))
    ks = tuple(int(k) for k in os.environ.get(
        "KSWEEP_KS", "12,14,16,18").split(","))
    seed = os.environ.get("KSWEEP_SEED")
    seed = int(seed) if seed else None

    t0 = time.time()
    d = synth_pool_dense_device(n_var=n_var, n_cell=n_cell,
                                n_donor=n_donor, doublet_rate=0.0,
                                density=0.01, seed=0)
    jax.block_until_ready(d["counts"].ad)
    t_gen = time.time() - t0

    t0 = time.time()
    sweep = sweep_n_donor(d["counts"], n_donor_list=ks, n_init=n_init,
                          max_iter_init=20, random_seed=seed,
                          verbose=True)
    t_sweep = time.time() - t0

    print(json.dumps({
        "metric": "k_sweep_%dkvar_x_%dkcell" % (n_var // 1000,
                                                n_cell // 1000),
        "value": round(t_sweep, 2),
        "unit": "s",
        "ks": list(ks),
        "n_init": n_init,
        "seeded": seed is not None,
        "gen_s": round(t_gen, 2),
        "best_K": sweep["best"],
        "true_K": n_donor,
        "top_elbo_per_K": {str(k): float(np.max(sweep[k])) for k in ks},
    }))


if __name__ == "__main__":
    main()
