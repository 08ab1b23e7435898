"""Ambient-RNA phase at the north star: time `predit_ambient` on a
fitted model over the 30k x 100k x 16 pool (int8 dense layout).

Round-3 review flagged that the selected-SNP block round-tripped
through host (hundreds of MB); the selection,
transpose and cast now stay on device, so the phase cost is the
vmapped per-cell EM plus the (C, K) result fetch. Prints one JSON
line.

Usage: python benchmarks/ambient_phase.py     (GPU)
       JAX_PLATFORMS=cpu AMB_CELLS=4000 AMB_VARS=2000 ... (CPU smoke)
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
    import jax.numpy as jnp

    from vireo_tpu.sim.synth import synth_pool_dense_device
    from vireo_tpu.models.vireo import (VireoConfig, Vireo, init_state,
                                        default_priors, run_em_iters)
    from vireo_tpu.models.ambient import predit_ambient

    n_var = int(os.environ.get("AMB_VARS", 30_000))
    n_cell = int(os.environ.get("AMB_CELLS", 100_000))
    n_donor = int(os.environ.get("AMB_DONORS", 16))

    t0 = time.time()
    d = synth_pool_dense_device(n_var=n_var, n_cell=n_cell,
                                n_donor=n_donor, doublet_rate=0.08,
                                density=0.01, seed=0)
    counts = d["counts"]
    jax.block_until_ready(counts.ad)
    t_gen = time.time() - t0

    # a converged-enough model to feed the ambient estimator
    cfg = VireoConfig(n_var=n_var, n_cell=n_cell, n_donor=n_donor)
    rng = np.random.RandomState(1)
    state = init_state(cfg, rng=rng, dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)
    t0 = time.time()
    state, _ = run_em_iters(counts, state, priors, cfg, 25)
    jax.block_until_ready(state.id_prob)
    t_fit = time.time() - t0

    vobj = Vireo(n_cell=n_cell, n_var=n_var, n_donor=n_donor,
                 ID_prob_init=np.asarray(jax.device_get(state.id_prob)),
                 GT_prob_init=np.asarray(jax.device_get(state.gt_prob)),
                 beta_mu_init=np.asarray(jax.device_get(state.beta_mu)),
                 beta_sum_init=np.asarray(jax.device_get(state.beta_sum)))

    # AMB_GAIN: override the reference-parity SNP gate sqrt(n_cell)/3
    # (vireo_doublet.py:230-240; exposed as --ambientMinGain on the
    # CLI) — the phase cost is ~proportional to the selected SNPs, so
    # this measures the time/coverage trade of stricter gates.
    gain = os.environ.get("AMB_GAIN")
    gain = float(gain) if gain else None
    t0 = time.time()
    Psi, Psi_var, Psi_llr = predit_ambient(vobj, counts, None,
                                           min_ELBO_gain=gain,
                                           rng=np.random.RandomState(2))
    t_amb = time.time() - t0

    print(json.dumps({
        "metric": "ambient_phase_%dkvar_x_%dkcell_x_%ddonor" % (
            n_var // 1000, n_cell // 1000, n_donor),
        "value": round(t_amb, 2),
        "unit": "s",
        "gen_s": round(t_gen, 2),
        "warm_fit_s": round(t_fit, 2),
        "min_ELBO_gain": gain if gain is not None else "default",
        "psi_shape": list(np.shape(Psi)),
        "mean_max_psi": float(np.mean(np.max(Psi, axis=1))),
        "finite": bool(np.isfinite(Psi).all()
                       and np.isfinite(Psi_llr).all()),
    }))


if __name__ == "__main__":
    main()
