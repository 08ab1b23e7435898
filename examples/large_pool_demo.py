"""Large-pool workflow: the capacity ladder and mesh in one script.

Shows what the engine does automatically for pools that dwarf the demo
data (the reference's only tool at this scale is manual --cellRange
chunking, vireo.py:136-142):

- `counts_from_scipy` picks the fastest exact device layout that fits
  the HBM budget (dense f32 -> int8/bf16 -> int8+overflow-residual
  hybrid -> nibble-packed (+hybrid) -> COO), printing its choice;
- `vireo_wrap(mesh="auto")` cell-shards the layout over all local
  devices for big pools;
- unseeded runs draw restart inits on device by default (no host
  np.random upload); an explicit random_seed keeps reference-RNG
  parity — at scale the exact np.random stream is REGENERATED ON
  DEVICE from ~2.5 MB of MT19937 states (ops/mt19937.py) instead of
  uploading the drawn floats (VIREO_DEVICE_INIT / VIREO_DEVICE_MT
  force either path).

The default sizing here is laptop-friendly; scale the env knobs up on
real hardware (benchmarks/e2e_100k.py and e2e_hybrid.py run the
30k x 100k x 16 north star).

Usage: [JAX_PLATFORMS=cpu] python examples/large_pool_demo.py
Env: LP_VARS/LP_CELLS/LP_DONORS/LP_INIT
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vireo_tpu.utils.platform import apply_compile_cache  # noqa: E402
apply_compile_cache()

from vireo_tpu import vireo_wrap  # noqa: E402
from vireo_tpu.ops.counts import counts_from_scipy  # noqa: E402
from vireo_tpu.sim.synth import synth_pool_counts  # noqa: E402

V = int(os.environ.get("LP_VARS", 2000))
C = int(os.environ.get("LP_CELLS", 3000))
K = int(os.environ.get("LP_DONORS", 6))
n_init = int(os.environ.get("LP_INIT", 10))

pool = synth_pool_counts(n_var=V, n_cell=C, n_donor=K,
                         doublet_rate=0.05, density=0.05, seed=0)

# the ladder chooses the layout; force the capacity rungs by shrinking
# the budget (VIREO_DENSE_BUDGET_GB) to see the hybrid/packed paths
counts = counts_from_scipy(pool["AD"], pool["DP"], verbose=True)

res = vireo_wrap(counts, n_donor=K, n_init=n_init, random_seed=1,
                 check_doublet=True, verbose=True, mesh="auto")

pred = np.argmax(res["ID_prob"], axis=1)
truth = pool["donor"]
from vireo_tpu.ops.matching import get_confusion  # noqa: E402
conf, _, _ = get_confusion(pred[pool["donor2"] < 0],
                           truth[pool["donor2"] < 0])
acc = conf.max(axis=0).sum() / max(conf.sum(), 1)
print("singlet agreement with simulated truth (up to relabeling): "
      "%.3f" % acc)
