"""Bulk-sample donor deconvolution via the library API.

Estimates donor fractions psi from a simulated multiplexed BULK sample
(per-variant alt/total count vectors + known genotype probabilities),
then runs the likelihood-ratio test against an equal-abundance null —
the `VireoBulk` surface of the reference (vireo_bulk.py:8-167).

Usage: [JAX_PLATFORMS=cpu] python examples/bulk_demo.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vireo_tpu.utils.platform import apply_compile_cache  # noqa: E402
apply_compile_cache()

from vireo_tpu import VireoBulk, LikRatio_test  # noqa: E402

# simulate a bulk pool of 3 donors at 55/30/15% with known genotypes
rng = np.random.RandomState(1)
n_var, K = 2000, 3
GT = rng.randint(0, 3, size=(n_var, K))
GT_prob = np.eye(3)[GT]                       # (n_var, K, 3) one-hot
theta_true = np.array([0.02, 0.5, 0.98])
psi_true = np.array([0.55, 0.30, 0.15])

rate = (GT_prob @ theta_true) @ psi_true
DP = rng.poisson(80, size=n_var) + 1
AD = rng.binomial(DP, rate)

np.random.seed(0)
model = VireoBulk(n_donor=K)
model.fit(AD, DP, GT_prob)
print("true  psi:", np.round(psi_true, 3))
print("fitted psi:", np.round(model.psi, 3))
print("fitted theta:", np.round(model.theta, 3))
assert np.abs(model.psi - psi_true).max() < 0.03

# likelihood-ratio test vs the equal-abundance null
LR, pval = LikRatio_test(model.psi, np.ones(K) / K, AD, DP, GT_prob,
                         model.theta)
print("LR statistic: %.1f   p-value: %.3g" % (LR, pval))
assert pval < 1e-6      # far from equal abundance

run_dir = os.environ.get("OUT", "/tmp/vireo_tpu_bulk")
os.makedirs(run_dir, exist_ok=True)
with open(os.path.join(run_dir, "bulk_fractions.tsv"), "w") as f:
    f.write("donor\tpsi\n")
    for k, p in enumerate(model.psi):
        f.write("donor%d\t%.6f\n" % (k, p))
print("fractions written to", run_dir)
