"""Measured END-TO-END reference run at the north star (CPU).

Round-2 review: the 294x headline compares inner EM iteration rates;
BASELINE.md also wants end-to-end configs. This script times the
REFERENCE implementation's full pipeline (vireo_wrap: n_init warm
restarts -> best refit -> doublet) on the same synthetic
100k-cell x 30k-variant x 16-donor pool the e2e benchmark uses
(benchmarks/e2e_100k.py), with the same n_init/seed, using both host
cores via the reference's own multiprocessing fan-out.

Expect tens of minutes. Prints one JSON line at the end.

Usage: python benchmarks/e2e_reference_cpu.py
Env:   E2E_VARS/E2E_CELLS/E2E_DONORS/E2E_INIT to shrink the config.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, "/root/reference")


def main():
    from vireo_tpu.sim.synth import synth_pool_counts
    from vireoSNP.utils.vireo_wrap import vireo_wrap as ref_wrap

    n_var = int(os.environ.get("E2E_VARS", 30_000))
    n_cell = int(os.environ.get("E2E_CELLS", 100_000))
    n_donor = int(os.environ.get("E2E_DONORS", 16))
    n_init = int(os.environ.get("E2E_INIT", 20))

    t0 = time.time()
    d = synth_pool_counts(n_var=n_var, n_cell=n_cell, n_donor=n_donor,
                          doublet_rate=0.08, density=0.01, seed=0)
    t_gen = time.time() - t0

    AD = d["AD"].tocsc()
    DP = d["DP"].tocsc()
    t0 = time.time()
    res = ref_wrap(AD, DP, n_donor=n_donor, n_init=n_init,
                   random_seed=1, check_doublet=True,
                   nproc=os.cpu_count() or 1)
    t_fit = time.time() - t0

    pred = np.argmax(res["ID_prob"], axis=1)
    print(json.dumps({
        "metric": "reference_cpu_e2e",
        "value": round(t_fit, 1),
        "unit": "s (load->restarts->refit->doublet)",
        "n_var": n_var, "n_cell": n_cell, "n_donor": n_donor,
        "n_init": n_init, "nproc": os.cpu_count(),
        "gen_s": round(t_gen, 1),
        "n_assigned": int(np.sum(res["ID_prob"].max(1) > 0.9)),
        "pred_donor_sizes": np.bincount(pred,
                                        minlength=n_donor).tolist(),
    }))


if __name__ == "__main__":
    main()
