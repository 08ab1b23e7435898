"""Clone reconstruction from mitochondrial variants — the
vireoSNP_clones notebook workflow (reference examples/vireoSNP_clones
.ipynb) as a script, on the bundled mkn45 mitoDNA data.

Runs the binomial-mixture VB with a clone-count sweep, prints the ELBO
distributions and the clone assignment table, and writes the
heatmap figures.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vireo_tpu.utils.platform import apply_compile_cache  # noqa: E402
apply_compile_cache()

from vireo_tpu import BinomMixtureVB  # noqa: E402
from vireo_tpu.io.matrices import read_mtx  # noqa: E402
from vireo_tpu.engine.select import sweep_n_clone  # noqa: E402

DATA = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data/mitoDNA"
OUT = sys.argv[2] if len(sys.argv) > 2 else "/tmp/vireo_tpu_clones"
os.makedirs(OUT, exist_ok=True)

AD = read_mtx(DATA + "/cellSNP.tag.AD.mtx")
DP = read_mtx(DATA + "/cellSNP.tag.DP.mtx")
print("data: %d variants x %d cells" % AD.shape)

# model selection over the number of clones
elbos = sweep_n_clone(AD, DP, n_clone_list=(2, 3, 4), n_init=50,
                      min_iter=30, random_seed=2)
print("best n_clone by max ELBO:", elbos["best"])

# final fit at the chosen K
K = elbos["best"]
model = BinomMixtureVB(n_cell=AD.shape[1], n_var=AD.shape[0], n_donor=K)
model.fit(AD, DP, n_init=50, min_iter=30, random_seed=2)

assign = np.argmax(model.ID_prob, axis=1)
print("clone sizes:", np.bincount(assign, minlength=K))
print("mean allelic ratio per clone (beta_mu):")
print(np.round(model.beta_mu.T, 3))

# figures: ELBO distributions across K and the AF heatmap by clone
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from vireo_tpu.plot import heat_matrix  # noqa: E402

fig = plt.figure(figsize=(10, 4))
plt.subplot(1, 2, 1)
plt.boxplot([elbos[k] for k in (2, 3, 4)], tick_labels=[2, 3, 4])
plt.xlabel("n_clones")
plt.ylabel("ELBO")

plt.subplot(1, 2, 2)
af = np.asarray(AD.todense()) / np.maximum(np.asarray(DP.todense()), 1)
order = np.argsort(assign)
heat_matrix(af[:, order].T, display_value=False, cmap="Blues")
plt.xlabel("variants")
plt.ylabel("cells (sorted by clone)")
plt.tight_layout()
fig.savefig(OUT + "/clones_summary.png", dpi=150)
print("wrote", OUT + "/clones_summary.png")
