"""Weak-scaling efficiency of the multi-process sharded EM fit.

Round-2 review finding: measuring *strong* scaling on one machine where
every virtual device shares the same cores conflates core contention
with communication overhead (0.61 "efficiency" at a latency-bound
sizing). This benchmark measures what localhost CAN measure honestly:

- WEAK scaling: per-process work is fixed (n_cell_per_proc cells);
  the global pool grows with the process count.
- one core per process via `taskset`, one XLA device per process, so
  up to 2 processes (this machine has 2 cores) each process computes
  at full, un-contended speed and the only added cost is the gloo
  all-reduce of the (n_var, 2K) sufficient statistics + the scalar
  ELBO term per EM iteration.
- a compute-bound sizing: per-process iteration time is tens of
  milliseconds, an order of magnitude above the ~1 ms localhost-TCP
  all-reduce.

Efficiency(P) = T(1 proc) / T(P procs) for the same per-process work.
On a GPU host the same code path rides NVLink through NCCL instead of
localhost TCP, so the TCP number is a lower bound.

P > n_cores runs are reported with "oversubscribed": true — they bound
contention, not communication — and are excluded from the efficiency
claim.

Usage: python benchmarks/scaling_weak.py [max_procs]
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_VAR = int(os.environ.get("WS_VARS", 3000))
CELLS_PER_PROC = int(os.environ.get("WS_CELLS_PER_PROC", 8000))
DENSITY = float(os.environ.get("WS_DENSITY", 0.04))
N_DONOR = int(os.environ.get("WS_DONORS", 8))
N_ITER = int(os.environ.get("WS_ITERS", 30))
PORT = int(os.environ.get("WS_PORT", 29891))


def worker(pid, nproc):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import time
    import numpy as np
    from vireo_tpu.parallel.mesh import (initialize_distributed, make_mesh,
                                         build_cell_sharded_coo,
                                         build_cell_sharded_dense,
                                         sharded_fit_vb,
                                         sharded_fit_vb_dense)
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors)
    from vireo_tpu.sim.synth import synth_pool_counts

    if nproc > 1:
        initialize_distributed(coordinator_address="127.0.0.1:%d" % PORT,
                               num_processes=nproc, process_id=pid)
    n_dev = len(jax.devices())
    assert n_dev == nproc, (n_dev, nproc)

    n_cell = CELLS_PER_PROC * nproc              # weak scaling
    d = synth_pool_counts(n_var=N_VAR, n_cell=n_cell, n_donor=N_DONOR,
                          doublet_rate=0.05, density=DENSITY, seed=0)
    layout = os.environ.get("WS_LAYOUT", "coo")
    if layout == "dense":
        ad, dp, meta = build_cell_sharded_dense(d["AD"], d["DP"], n_dev,
                                                dtype=np.float32)
    else:
        arrays, meta = build_cell_sharded_coo(d["AD"], d["DP"], n_dev)
    cfg = VireoConfig(n_var=N_VAR, n_cell=meta["n_cell_pad"],
                      n_donor=N_DONOR)
    rng = np.random.RandomState(1)
    state = init_state(cfg, rng=rng, dtype=np.float32)
    priors = default_priors(cfg, dtype=np.float32)
    mesh = make_mesh()

    if layout == "dense":
        run = lambda it: sharded_fit_vb_dense(
            mesh, ad, dp, meta, state, priors, cfg,
            min_iter=it, max_iter=it)
    else:
        run = lambda it: sharded_fit_vb(mesh, arrays, meta, state,
                                        priors, cfg, min_iter=it,
                                        max_iter=it)
    jax.block_until_ready(run(1).elbo_final)         # compile 1-iter
    jax.block_until_ready(run(N_ITER).elbo_final)    # compile N-iter
    dt = float("inf")
    for _ in range(3):
        t0 = time.time()
        r = run(N_ITER)
        jax.block_until_ready(r.elbo_final)
        dt = min(dt, time.time() - t0)
    # 1-iter repeat isolates the per-call dispatch overhead
    dt1 = float("inf")
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(run(1).elbo_final)
        dt1 = min(dt1, time.time() - t0)

    if pid == 0:
        print(json.dumps({
            "n_processes": nproc,
            "n_cell_global": n_cell,
            "layout": layout,
            "nnz_per_proc": int(meta.get("nnz_pad", -1)),
            "fit_s": round(dt, 4),
            "iter_ms": round(1e3 * (dt - dt1) / (N_ITER - 1), 3),
            "elbo": float(r.elbo_final),
        }))


def launch(nproc, n_cores):
    """Run one weak-scaling point: nproc workers, one pinned core each
    (cores reused round-robin when oversubscribed)."""
    procs = []
    have_taskset = shutil.which("taskset") is not None
    for p in range(nproc):
        cmd = [sys.executable, __file__, "--worker", str(p), str(nproc)]
        if have_taskset:
            cmd = ["taskset", "-c", str(p % n_cores)] + cmd
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True))
    outs = [pr.communicate(timeout=1200)[0] for pr in procs]
    assert all(pr.returncode == 0 for pr in procs), \
        "worker failed at P=%d" % nproc
    return json.loads([ln for o in outs for ln in o.splitlines()
                       if ln.startswith("{")][-1])


def main():
    max_procs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_cores = os.cpu_count() or 1
    points = []
    P = 1
    while P <= max_procs:
        res = launch(P, n_cores)
        res["oversubscribed"] = P > n_cores
        if points:
            res["weak_efficiency"] = round(
                points[0]["fit_s"] / res["fit_s"], 4)
        points.append(res)
        print(json.dumps(res))
        P *= 2
    in_core = [p for p in points[1:] if not p["oversubscribed"]]
    summary = {
        "metric": "weak_scaling_efficiency",
        "value": in_core[-1]["weak_efficiency"] if in_core else None,
        "unit": "T1/TP @%d procs, 1 core/proc" % (
            in_core[-1]["n_processes"] if in_core else 0),
        "cells_per_proc": CELLS_PER_PROC,
        "n_var": N_VAR,
        "n_cores": n_cores,
        "points": points,
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
