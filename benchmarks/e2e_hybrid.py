"""End-to-end vireo_wrap on the HYBRID rung: a heavy-tailed
30k x 100k x 16 pool (max count >> 256) built from scipy input via
counts_from_scipy — the regime that previously ran on the pure-COO
fallback. Full pipeline: layout build -> warm restarts -> refit ->
doublet. Prints one JSON line.

Usage: python benchmarks/e2e_hybrid.py
Env: E2E_VARS/E2E_CELLS/E2E_DONORS/E2E_INIT/E2E_HOT to resize.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    from vireo_tpu.utils.platform import apply_compile_cache
    apply_compile_cache()
    import scipy.sparse as sp
    from vireo_tpu.ops.counts import counts_from_scipy, HybridCounts
    from vireo_tpu.engine.wrap import vireo_wrap

    V = int(os.environ.get("E2E_VARS", 30_000))
    C = int(os.environ.get("E2E_CELLS", 100_000))
    K = int(os.environ.get("E2E_DONORS", 16))
    n_init = int(os.environ.get("E2E_INIT", 20))
    hot_frac = float(os.environ.get("E2E_HOT", 0.002))
    density = 0.01

    # heavy-tailed pool with planted donor/doublet truth
    rng = np.random.RandomState(0)
    nnz = int(V * C * density)
    rows = rng.randint(0, V, size=nnz)
    cols = rng.randint(0, C, size=nnz)
    GT = rng.randint(0, 3, size=(V, K))
    theta = np.array([0.02, 0.5, 0.98])
    donor = rng.randint(0, K, size=C)
    is_dbl = rng.rand(C) < 0.08
    donor2 = np.where(is_dbl, rng.randint(0, K, size=C), -1)

    dp = rng.poisson(3.0, size=nnz) + 1
    hot = rng.rand(nnz) < hot_frac
    dp = dp + hot * rng.randint(200, 2000, size=nnz)
    p = theta[GT[rows, donor[cols]]]
    p2 = theta[GT[rows, donor2[cols]]]
    use2 = (donor2[cols] >= 0) & (rng.rand(nnz) < 0.5)
    p = np.where(use2, p2, p)
    ad = rng.binomial(dp, p)
    DP = sp.csr_matrix((dp.astype(np.float64), (rows, cols)),
                       shape=(V, C))
    AD = sp.csr_matrix((ad.astype(np.float64), (rows, cols)),
                       shape=(V, C))
    DP.sum_duplicates()
    AD.sum_duplicates()

    t0 = time.time()
    counts = counts_from_scipy(AD, DP, verbose=True)
    layout = type(counts).__name__
    t_build = time.time() - t0

    # unseeded by default (the production default: device-side warm
    # inits, no ~250 MB host upload); E2E_SEED restores host-RNG parity
    seed = os.environ.get("E2E_SEED")
    seed = int(seed) if seed else None
    t0 = time.time()
    res = vireo_wrap(counts, n_donor=K, n_init=n_init, random_seed=seed,
                     check_doublet=True, verbose=False,
                     timing=os.environ.get("VIREO_TIMING") == "1" or None)
    t_fit = time.time() - t0

    ID_prob = res["ID_prob"]
    pred = np.argmax(ID_prob, axis=1)
    prob_max = ID_prob.max(axis=1)
    from scipy.optimize import linear_sum_assignment
    Cm = np.zeros((K, K))
    singlets = ~is_dbl
    for t in range(K):
        m = singlets & (donor == t)
        for q in range(K):
            Cm[t, q] = np.sum(pred[m] == q)
    ti, pi = linear_sum_assignment(-Cm)
    remap = np.empty(K, np.int64)
    remap[pi] = ti
    conf = singlets & (prob_max >= 0.9)
    acc = float(np.mean(remap[pred[conf]] == donor[conf]))

    print(json.dumps({
        "metric": "e2e_hybrid_100k",
        "value": round(t_fit, 2), "unit": "s",
        "layout": layout, "max_count": int(dp.max()),
        "build_s": round(t_build, 1),
        "singlet_accuracy": round(acc, 4),
        "assigned_frac": round(float(np.mean(conf[singlets])), 4),
    }))


if __name__ == "__main__":
    main()
