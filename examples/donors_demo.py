"""Donor demultiplexing via the library API — the vireoSNP_donors
notebook workflow (reference examples/vireoSNP_donors.ipynb) as a
script, on the bundled demo data.

Loads the cellSNP sparse matrices, runs the multi-init wrapped fit with
doublet detection, derives the hard calls with the notebook's 0.9
thresholds, plots the assignment-probability and mean-allelic-ratio
heatmaps, and prints a donor-size table.

Usage: [JAX_PLATFORMS=cpu] python examples/donors_demo.py [data] [out]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vireo_tpu.utils.platform import apply_compile_cache  # noqa: E402
apply_compile_cache()

from vireo_tpu import vireo_wrap  # noqa: E402
from vireo_tpu.io.matrices import read_cellSNP  # noqa: E402

DATA = sys.argv[1] if len(sys.argv) > 1 else \
    "/root/reference/data/cellSNP_mat"
OUT = sys.argv[2] if len(sys.argv) > 2 else "/tmp/vireo_tpu_donors"
os.makedirs(OUT, exist_ok=True)

cell_dat = read_cellSNP(DATA)
AD, DP = cell_dat["AD"], cell_dat["DP"]
print("data: %d variants x %d cells" % AD.shape)

res = vireo_wrap(AD, DP, n_donor=4, learn_GT=True, n_extra_donor=0,
                 ASE_mode=False, fix_beta_sum=False, n_init=50,
                 check_doublet=True, random_seed=1)

# hard calls with the notebook's thresholds
donor_best = np.argmax(res["ID_prob"], axis=1)
is_doublet = np.sum(res["doublet_prob"], axis=1) > 0.9
is_unassigned = (np.max(res["ID_prob"], axis=1) < 0.9) & (~is_doublet)
print("%d cells are called doublet" % is_doublet.sum())
print("%d cells are unassigned to singlet or doublets"
      % is_unassigned.sum())
for k in range(4):
    n = np.sum((donor_best == k) & ~is_doublet & ~is_unassigned)
    print("donor%d: %d cells" % (k, n))

# figures: assignment probabilities + mean allelic ratio per donor
import matplotlib  # noqa: E402
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from vireo_tpu.plot.base_plot import heat_matrix  # noqa: E402

assign_comb = np.append(res["ID_prob"],
                        res["doublet_prob"].sum(1, keepdims=True), axis=1)
fig = plt.figure(figsize=(4, 5), dpi=100)
im = heat_matrix(assign_comb[:100], cmap="Oranges", alpha=0.8,
                 display_value=False, row_sort=True)
plt.colorbar(im, fraction=0.046, pad=0.04)
plt.title("Assignment probability (first 100 cells)")
plt.xlabel("Donor (last column: doublet)")
plt.tight_layout()
fig.savefig(os.path.join(OUT, "assign_prob.png"))
plt.close(fig)

AF_SNPs = np.tensordot(res["GT_prob"], res["theta_mean"][0, :],
                       axes=[2, 0])
fig = plt.figure(figsize=(4, 5), dpi=100)
im = heat_matrix(AF_SNPs[:200], cmap="GnBu", alpha=0.8,
                 display_value=False, row_sort=True)
plt.colorbar(im, fraction=0.046, pad=0.04)
plt.title("Mean allelic ratio")
plt.xlabel("Donors")
plt.tight_layout()
fig.savefig(os.path.join(OUT, "allelic_ratio.png"))
plt.close(fig)
print("figures written to", OUT)
