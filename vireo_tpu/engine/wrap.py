"""Multi-initialization orchestrator for the Vireo model.

Re-implements the reference wrapper
(/root/reference/vireoSNP/utils/vireo_wrap.py:22-183) with a
device-first execution model: the n_init random restarts run as ONE
vmapped device call (instead of a multiprocessing.Pool of forked fits,
vireo_wrap.py:74-83), followed by best-ELBO selection and a long refit.
All mode-resolution branches (extra-donor search, subset/superset donor
priors, doublet and ambient dispatch) are preserved host-side.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.counts import (DenseCounts, SparseCounts, HybridCounts,
                          counts_from_scipy)
from ..utils.fetch import host_fetch, host_put
from ..ops.matching import optimal_match, donor_select
from ..models.vireo import (Vireo, VireoConfig, default_priors,
                            fit_vb)
from ..models.doublet import predict_doublet
from ..models.ambient import predit_ambient

__all__ = ["vireo_wrap"]


def _cell_sharding(mesh):
    """Sharding for the (n_var, n_cell) count matrices: cells always,
    variants too on a 2-D capacity mesh."""
    from jax.sharding import NamedSharding
    from ..parallel.mesh import count_spec
    return NamedSharding(mesh, count_spec(mesh))


def _resolve_mesh(mesh, n_cell, count_bytes=None, var_state_bytes=None,
                  verbose=False):
    """mesh="auto": shard cells over all local devices when the data is
    big enough to pay for collectives (VIREO_MESH=off disables;
    VIREO_MESH_MIN_CELLS tunes the threshold; VIREO_MESH_SHAPE="2x4"
    forces a 2-D vars-x-cells capacity mesh). Explicit Mesh / None
    pass through.

    When size hints are given, the 2-D capacity mesh is elected
    AUTOMATICALLY: a 1-D cells mesh replicates every variant-axis array
    per chip — dominated by the (n_init, n_var, K, G) warm genotype
    batch — so when per-chip count shard + replicated variant state
    exceeds the per-chip HBM budget but sharding variants `a` ways
    would fit, the smallest power-of-two vars extent that fits wins
    (round-4 verdict #4: previously 2-D was manual-only and such pools
    fell down the ladder to packed/hybrid/COO instead)."""
    if mesh != "auto":
        return mesh
    import os
    if os.environ.get("VIREO_MESH", "auto").lower() in ("0", "off", "no"):
        return None
    min_cells = int(os.environ.get("VIREO_MESH_MIN_CELLS", 8192))
    if n_cell >= min_cells and len(jax.devices()) > 1:
        from ..parallel.mesh import make_mesh, make_mesh2d
        shape = os.environ.get("VIREO_MESH_SHAPE", "")
        if shape:
            nv, nc = (int(s) for s in shape.lower().split("x"))
            return make_mesh2d(nv, nc)
        n_dev = len(jax.devices())
        if var_state_bytes:
            from ..ops.counts import device_dense_budget
            budget = device_dense_budget()
            per_chip = (count_bytes or 0) / n_dev
            if per_chip + var_state_bytes > budget:
                a = 2
                while a <= n_dev // 2:
                    if n_dev % a == 0 and \
                            per_chip + var_state_bytes / a <= budget:
                        if verbose:
                            print("[vireo] replicated variant-axis "
                                  "state (%.2f GiB) busts the per-chip "
                                  "budget on a 1-D cells mesh; using a "
                                  "%dx%d vars-x-cells capacity mesh"
                                  % (var_state_bytes / 2**30, a,
                                     n_dev // a))
                        return make_mesh2d(a, n_dev // a)
                    a *= 2
        return make_mesh()
    return None


def _auto_mesh_hints(AD, DP, n_donor, GT_prior, n_extra_donor, n_init,
                     n_GT, dtype):
    """(count_bytes, var_state_bytes) estimates for the 2-D mesh
    election in `_resolve_mesh`; (None, None) for pre-built counts
    objects (already placed — no election).

    count_bytes: both dense matrices in the smallest exact dtype the
    ladder would pick. var_state_bytes: the variant-axis arrays a 1-D
    cells mesh replicates per chip — dominated by the warm-restart
    genotype batch (n_init, n_var, K, G) plus the fit/doublet copies.
    """
    if hasattr(AD, "suff_stats"):
        return None, None
    try:
        from ..ops.counts import exact_count_dtype
        n_var, n_cell = (int(s) for s in AD.shape)
        vmax = 0.0
        for X in (AD, DP):
            data = X.data if hasattr(X, "data") else np.asarray(X)
            if getattr(data, "size", 0):
                vmax = max(vmax, float(data.max()))
        count_bytes = 2.0 * n_var * n_cell * jnp.dtype(
            exact_count_dtype(vmax)).itemsize
        # mirror the wrap's donor-count resolution: a prior with MORE
        # donors than requested widens the fit to the prior's width
        # (vireo_wrap.py:111-119) — sizing with the smaller K would
        # under-estimate the warm genotype batch and skip the capacity
        # mesh exactly when it is needed
        K = int(n_donor) if n_donor is not None else (
            int(GT_prior.shape[1]) if GT_prior is not None else 8)
        K += int(n_extra_donor or 0)
        if GT_prior is not None:
            K = max(K, int(GT_prior.shape[1]))
        var_state_bytes = ((int(n_init) + 2) * n_var * K * n_GT
                           * jnp.dtype(dtype).itemsize)
        return count_bytes, var_state_bytes
    except Exception:
        return None, None


def _pad_cells(X, n_pad):
    """Append `n_pad` zero-count cells (columns) to a scipy/numpy
    count matrix."""
    import scipy.sparse as sp
    if sp.issparse(X):
        pad = sp.csc_matrix((X.shape[0], n_pad), dtype=X.dtype)
        return sp.hstack([X.tocsc(), pad]).tocsc()
    return np.pad(np.asarray(X), ((0, 0), (0, n_pad)))


def _mesh_native(counts):
    """Counts objects that carry their own mesh axis (MeshPackedCounts,
    or a hybrid over one) are already placed."""
    return (getattr(counts, "axis", None) is not None
            or getattr(getattr(counts, "base", None), "axis", None)
            is not None)


def _as_counts(AD, DP, dtype, mesh=None, verbose=False):
    """Returns (counts, mesh_placed). `mesh_placed` is True only when
    the counts actually ended up cell-sharded on the mesh — the caller
    must not report sharding otherwise."""
    if hasattr(AD, "suff_stats"):     # already a device counts object
        counts = AD
        if mesh is None:
            return counts, False
        if _mesh_native(counts):
            return counts, True
        from ..parallel.mesh import n_cell_shards
        size = n_cell_shards(mesh)
        if isinstance(counts, DenseCounts) and counts.n_cell % size == 0:
            sh = _cell_sharding(mesh)
            counts = DenseCounts(jax.device_put(counts.ad, sh),
                                 jax.device_put(counts.dp, sh))
            return counts, True
        if isinstance(counts, HybridCounts) \
                and isinstance(counts.base, DenseCounts) \
                and counts.n_cell % size == 0:
            from jax.sharding import NamedSharding, PartitionSpec
            sh = _cell_sharding(mesh)
            rep = NamedSharding(mesh, PartitionSpec())
            counts = dataclasses.replace(
                counts,
                base=DenseCounts(jax.device_put(counts.base.ad, sh),
                                 jax.device_put(counts.base.dp, sh)),
                resid=jax.tree.map(lambda x: jax.device_put(x, rep),
                                   counts.resid),
                binom_corr=jax.device_put(counts.binom_corr, rep))
            return counts, True
        import warnings
        warnings.warn(
            "[vireo] pre-built %s counts (n_cell=%d) could not be "
            "placed on the mesh (cell axis not divisible by its %d "
            "shards, or layout has no mesh path); the run proceeds "
            "UNSHARDED. Pad the cell axis to a multiple of the shard "
            "count, or pass raw scipy/numpy matrices so vireo_wrap "
            "pads for you." % (type(counts).__name__, counts.n_cell,
                               size))
        return counts, False
    sharding = _cell_sharding(mesh) if mesh is not None else None
    counts = counts_from_scipy(AD, DP, dtype=dtype, sharding=sharding,
                               verbose=verbose)
    # the COO fallback rung has no sharded layout
    placed = mesh is not None and not isinstance(counts, SparseCounts)
    return counts, placed


@jax.jit
def _tree_take(tree, i):
    """tree[i] over the leading axis of every leaf, as one device call."""
    return jax.tree.map(lambda x: x[i], tree)


@functools.partial(jax.jit, static_argnames=("cfg", "max_iter_init",
                                             "delay_fit_theta"))
def _warm_select(counts, batched, priors, cfg, max_iter_init,
                 delay_fit_theta):
    """The whole warm phase as ONE device call: vmapped restart fits,
    best-ELBO winner slice, binomial constant — no host round trip
    between them.

    Selection is argmax over the raw per-restart ELBOs — identical to
    the reference's argmax over ELBO + binomial constant (adding one
    constant in f64 is monotone and preserves exact ties, and both
    argmaxes take the first maximum); the constant is returned so the
    host can report reference-style values."""
    warm = jax.vmap(lambda st: fit_vb(
        counts, st, priors, cfg, max_iter=max_iter_init,
        min_iter=5, delay_fit_theta=delay_fit_theta))(batched)
    best = jnp.argmax(warm.elbo_ref)
    return (_tree_take(warm.state, best), warm.elbo_ref,
            counts.binom_coeff_sum())


def _env_tristate(name, on_default):
    """Three-way env knob: "1/on/yes" -> True, "0/off/no" -> False,
    anything else -> `on_default`."""
    import os
    knob = os.environ.get(name, "").lower()
    if knob in ("1", "on", "yes"):
        return True
    if knob in ("0", "off", "no"):
        return False
    return on_default


def _batched_beta(cfg, n_init, np_dtype):
    """The (n_init, L, G) beta_mu/beta_sum init arrays every batched
    init shares (reference defaults, vireo_model.py:78-93)."""
    L, G = cfg.theta_len, cfg.n_GT
    beta_mu = np.broadcast_to(
        (np.ones((L, G)) * np.linspace(0.01, 0.99, G)[None, :]).astype(
            np_dtype), (n_init, L, G))
    beta_sum = np.full((n_init, L, G), 50.0, np_dtype)
    return jnp.asarray(beta_mu), jnp.asarray(beta_sum)


def _host_batched_init(cfg, n_init, GT_prior_use, rng, dtype,
                       n_cell_draw=None):
    """The reference's per-restart np.random draws (identical stream
    order and per-restart normalization, vireo_model.py:95-104),
    assembled into ONE batched host array per field and uploaded once
    — the per-restart `init_state` + device-stack path paid ~80 device
    calls and gigabytes of host copies at the 100k-cell scale.

    `n_cell_draw` < cfg.n_cell draws at the true cell count and pads
    the remainder with the uniform prior (mesh cell padding must not
    shift the host RNG stream)."""
    from ..models.vireo import VireoState
    G = cfg.n_GT
    K = cfg.n_donor
    C = cfg.n_cell
    c_draw = C if n_cell_draw is None else int(n_cell_draw)
    np_dtype = np.dtype(jnp.dtype(dtype).name)

    id_b = np.empty((n_init, C, K), np_dtype)
    gt_b = np.empty((n_init, cfg.n_var, K, G), np_dtype)
    id_b[:, c_draw:, :] = 1.0 / K
    if GT_prior_use is not None:
        gp = np.asarray(GT_prior_use, np.float64)
        gp = gp / gp.sum(-1, keepdims=True)
    for i in range(n_init):
        idp = rng.rand(c_draw, K)
        id_b[i, :c_draw] = idp / idp.sum(1, keepdims=True)
        if GT_prior_use is None:
            gtp = rng.rand(cfg.n_var, K, G)
            gt_b[i] = gtp / gtp.sum(-1, keepdims=True)
        else:
            gt_b[i] = gp
    beta_mu, beta_sum = _batched_beta(cfg, n_init, np_dtype)
    return VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                      gt_prob=host_put(gt_b),
                      id_prob=host_put(id_b))


def _mt_batched_init(cfg, n_init, GT_prior_use, rng, dtype,
                     n_cell_draw=None):
    """The reference's per-restart np.random draws REGENERATED ON
    DEVICE from ~2.5 MB of MT19937 lane states (ops/mt19937.py),
    replacing `_host_batched_init`'s ~240 MB float upload at the
    100k-cell scale. The host stream advances exactly as if it had
    drawn the inits itself, so later host draws stay stream-identical.

    The produced VireoState is BIT-IDENTICAL to `_host_batched_init`:
    the stream and the per-restart normalizations run in f64 on device
    (scoped x64 when the process runs in f32), where the double
    transform is exact and the normalizations replicate numpy's
    pairwise summation order; only the result is cast to `dtype`, the
    one rounding the host path also makes.
    """
    from ..ops.mt19937 import (plan_stream, device_stream,
                               np_pairwise_sum_last)
    from ..models.vireo import VireoState
    G = cfg.n_GT
    K, C, V = cfg.n_donor, cfg.n_cell, cfg.n_var
    c_draw = C if n_cell_draw is None else int(n_cell_draw)
    gt_draw = 0 if GT_prior_use is not None else V * K * G
    per = c_draw * K + gt_draw
    plan = plan_stream(n_init * per, rng=rng)

    gp = None
    if GT_prior_use is not None:
        gp = np.asarray(GT_prior_use, np.float64)
        gp = gp / gp.sum(-1, keepdims=True)

    @jax.jit
    def build(stream):
        flat = stream.reshape(n_init, per)
        idp = flat[:, :c_draw * K].reshape(n_init, c_draw, K)
        idn = (idp / np_pairwise_sum_last(idp)[..., None]).astype(dtype)
        if c_draw < C:
            pad = jnp.full((n_init, C - c_draw, K), 1.0 / K, dtype)
            idn = jnp.concatenate([idn, pad], axis=1)
        if gt_draw:
            gtp = flat[:, c_draw * K:].reshape(n_init, V, K, G)
            gtn = (gtp
                   / np_pairwise_sum_last(gtp)[..., None]).astype(dtype)
        else:
            gtn = jnp.broadcast_to(jnp.asarray(gp, dtype),
                                   (n_init, V, K, G))
        return idn, gtn

    with jax.enable_x64(True):
        idn, gtn = build(device_stream(plan, dtype=jnp.float64))
    beta_mu, beta_sum = _batched_beta(
        cfg, n_init, np.dtype(jnp.dtype(dtype).name))
    return VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                      gt_prob=gtn, id_prob=idn)


def _device_init_policy(random_seed):
    """Shared VIREO_DEVICE_INIT resolution (wrap + K-sweep): True =
    draw warm inits on device (unseeded default), False = host
    np.random stream (seeded default, reference parity)."""
    return _env_tristate("VIREO_DEVICE_INIT", random_seed is None)


# seeded init streams at least this many doubles (~67 MB as uploaded
# f32) default to the device MT19937 generator; demo-scale golden runs
# stay below it on the bit-for-bit host path
_MT_STREAM_MIN_DOUBLES = 1 << 23


def _seeded_batched_init(cfg, n_init, GT_prior_use, rng, dtype,
                         n_cell_draw=None):
    """Seeded-run init dispatch: the reference-parity np.random stream,
    assembled either on host (one batched upload) or regenerated on
    device (ops/mt19937.py). VIREO_DEVICE_MT=1/0 forces a path."""
    c_draw = cfg.n_cell if n_cell_draw is None else int(n_cell_draw)
    n_total = n_init * (c_draw * cfg.n_donor
                        + (0 if GT_prior_use is not None
                           else cfg.n_var * cfg.n_donor * cfg.n_GT))
    use_mt = _env_tristate("VIREO_DEVICE_MT",
                           n_total >= _MT_STREAM_MIN_DOUBLES)
    init = _mt_batched_init if use_mt else _host_batched_init
    return init(cfg, n_init, GT_prior_use, rng, dtype,
                n_cell_draw=n_cell_draw)


def _device_batched_init(cfg, n_init, seed, GT_prior_use, dtype):
    """Draw the n_init restart states ON DEVICE (jax PRNG).

    The DEFAULT for unseeded runs (and forcible via VIREO_DEVICE_INIT=1
    even when seeded): skips the reference-parity host np.random draws
    and their ~250 MB host->device upload at the 100k-cell scale.
    Deterministic in `seed`, but NOT stream-compatible with the
    reference's np.random inits — seeded runs therefore default to the
    host path, preserving golden parity (vireo_wrap.py:52-54).
    """
    import jax.random as jr
    from ..models.vireo import VireoState
    L, G = cfg.theta_len, cfg.n_GT
    beta_mu = jnp.broadcast_to(
        jnp.asarray(np.ones((L, G)) * np.linspace(0.01, 0.99, G)[None, :],
                    dtype), (n_init, L, G))
    beta_sum = jnp.full((n_init, L, G), 50.0, dtype)

    @jax.jit
    def draw(key):
        k1, k2 = jr.split(key)
        idp = jr.uniform(k1, (n_init, cfg.n_cell, cfg.n_donor), dtype)
        idp = idp / idp.sum(-1, keepdims=True)
        if GT_prior_use is None:
            gtp = jr.uniform(k2, (n_init, cfg.n_var, cfg.n_donor,
                                  cfg.n_GT), dtype)
        else:
            gtp = jnp.broadcast_to(jnp.asarray(GT_prior_use, dtype),
                                   (n_init, cfg.n_var, cfg.n_donor,
                                    cfg.n_GT))
        gtp = gtp / gtp.sum(-1, keepdims=True)
        return idp, gtp

    idp, gtp = draw(jr.PRNGKey(0 if seed is None else int(seed)))
    return VireoState(beta_mu=beta_mu, beta_sum=beta_sum, gt_prob=gtp,
                      id_prob=idp)


def _model_from_state(counts, cfg_kwargs, n_donor, learn_GT, state,
                      GT_prior_use, dtype, device_state=False):
    """Build a Vireo wrapper seeded with an existing state (no RNG draws).

    `device_state=True` adopts the state's device arrays verbatim
    (placeholder host inits, then overwrite) — for states with no
    host-RNG parity contract (device-init runs): skips fetching and
    re-uploading the (C, K) posterior and its host renormalization at
    the 100k-cell scale."""
    if device_state:
        m = Vireo(n_cell=counts.n_cell, n_var=counts.n_var,
                  n_donor=n_donor, learn_GT=learn_GT, dtype=dtype,
                  state_init=state, **cfg_kwargs)
        m.set_prior(GT_prior=GT_prior_use)
        return m
    m = Vireo(n_cell=counts.n_cell, n_var=counts.n_var, n_donor=n_donor,
              learn_GT=learn_GT, dtype=dtype,
              beta_mu_init=np.asarray(state.beta_mu),
              beta_sum_init=np.asarray(state.beta_sum),
              ID_prob_init=host_fetch(state.id_prob),
              GT_prob_init=np.asarray(state.gt_prob), **cfg_kwargs)
    m.set_prior(GT_prior=GT_prior_use)
    return m


def _profiled(fn):
    """VIREO_PROFILE=<dir> captures a JAX profiler trace of the whole
    run (view with TensorBoard/xprof); no-op otherwise."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import os
        from ..utils.timing import profile_trace
        with profile_trace(os.environ.get("VIREO_PROFILE")):
            return fn(*args, **kwargs)
    return wrapper


@_profiled
def vireo_wrap(AD, DP=None, GT_prior=None, n_donor=None, learn_GT=True,
               n_init=20, random_seed=None, check_doublet=True,
               max_iter_init=20, delay_fit_theta=3, n_extra_donor=0,
               extra_donor_mode="distance", check_ambient=False,
               ambient_min_gain=None, nproc=None, dtype=jnp.float32,
               verbose=True, mesh="auto", checkpoint_dir=None,
               timing=None, **kwargs):
    """Run vireo with multiple initializations; returns the reference's
    result dict (vireo_wrap.py:170-183).

    `nproc` is accepted for CLI parity and ignored (restarts are
    vmapped on device). `kwargs` may carry model flags (ASE_mode,
    fix_beta_sum, learn_theta, n_GT).

    `mesh`: "auto" (default) builds a cell-sharded mesh over all local
    devices when the pool is large enough; pass an explicit
    `jax.sharding.Mesh` or None to override. Dense counts and the cell
    axis are sharded across it (sufficient statistics all-reduced each
    iteration); XLA propagates the sharding through the warm restarts,
    refit and doublet phases.

    `checkpoint_dir`: when set, the best warm-restart state (step 0)
    and the fully refit pre-doublet state (step 1) are saved there
    with the host RNG position; a rerun with the SAME arguments resumes
    after the latest completed phase and reproduces the uninterrupted
    result. `timing` (or VIREO_TIMING=1) prints a per-phase summary.
    Note: device work dispatches asynchronously, so a phase's cost can
    surface in the first phase that blocks on its results — e.g. the
    data_placement transfer often lands in warm_restarts. The split is
    deliberately left unsynchronized: blocking each phase would
    serialize real overlap (host init draws run during the upload).
    """
    import os
    from ..utils.timing import PhaseTimer
    from ..utils import checkpoint as ckpt

    if timing is None:
        timing = os.environ.get("VIREO_TIMING", "0").lower() \
            not in ("0", "", "no", "off")
    timer = PhaseTimer() if timing else None

    def phase(name):
        import contextlib
        return timer.phase(name) if timer else contextlib.nullcontext()

    resume = ckpt.latest_step(checkpoint_dir) if checkpoint_dir else None
    if resume is not None and verbose:
        print("[vireo] resuming from checkpoint step %d in %s"
              % (resume, checkpoint_dir))

    n_cell_in = AD.n_cell if hasattr(AD, "suff_stats") \
        else int(AD.shape[1])
    # size hints (a data max() scan) only matter when an auto mesh
    # could actually be elected
    if mesh == "auto" and len(jax.devices()) > 1:
        count_bytes, var_state_bytes = _auto_mesh_hints(
            AD, DP, n_donor, GT_prior, n_extra_donor, n_init,
            int(kwargs.get("n_GT", 3)), dtype)
    else:
        count_bytes = var_state_bytes = None
    mesh = _resolve_mesh(mesh, n_cell_in, count_bytes=count_bytes,
                         var_state_bytes=var_state_bytes,
                         verbose=verbose)
    # sharded placement needs the cell axis divisible by the mesh: pad
    # with zero-count cells (assignment = prior, removed from every
    # returned array below; random inits are drawn at the TRUE cell
    # count so a padded mesh run reproduces the unpadded seeded run)
    n_pad_cells = 0
    if mesh is not None and not hasattr(AD, "suff_stats"):
        from ..parallel.mesh import n_cell_shards
        shards = n_cell_shards(mesh)
        rem = n_cell_in % shards
        if rem:
            n_pad_cells = shards - rem
            AD = _pad_cells(AD, n_pad_cells)
            DP = _pad_cells(DP, n_pad_cells)
    with phase("data_placement"):
        counts, mesh_placed = _as_counts(AD, DP, dtype, mesh=mesh,
                                         verbose=verbose)
    if mesh_placed and verbose:
        print("[vireo] counts sharded over %d devices (mesh %s)"
              % (mesh.devices.size, dict(mesh.shape)))

    if learn_GT is False and n_extra_donor > 0:
        print("Searching from extra donors only works with learn_GT")
        n_extra_donor = 0

    if n_donor is None:
        if GT_prior is None:
            raise ValueError("[vireo] Error: requiring n_donor or GT_prior.")
        n_donor = GT_prior.shape[1]

    if learn_GT is False and n_init > 1:
        print("GT is fixed, so use a single initialization")
        n_init = 1

    if random_seed is not None:
        np.random.seed(random_seed)
    rng = np.random  # the reference draws from the global stream

    # warm-restart init placement: the host np.random draws exist only
    # to reproduce the reference's seeded RNG stream (vireo_wrap.py:
    # 52-54, vireo_model.py:95-104). Unseeded runs carry no such parity
    # contract, so they default to on-device jax PRNG inits — skipping
    # a ~250 MB host->device upload at the 100k-cell scale.
    # VIREO_DEVICE_INIT=1/0 forces either path.
    device_init = _device_init_policy(random_seed)

    # run fingerprint: refuse to resume from a checkpoint directory
    # written with different data/arguments (advisor round-2 finding —
    # shape-compatible stale state would silently corrupt results)
    run_fp = {
        "n_var": int(counts.n_var), "n_cell": int(counts.n_cell),
        "nnz": int(getattr(counts, "nnz", -1)),
        "n_donor": int(n_donor), "n_init": int(n_init),
        "random_seed": -1 if random_seed is None else int(random_seed),
        "learn_GT": int(bool(learn_GT)),
        "n_extra_donor": int(n_extra_donor),
        "has_GT_prior": int(GT_prior is not None),
        "device_init": int(device_init),
    }
    if resume is not None:
        ckpt.check_fingerprint(checkpoint_dir, run_fp)

    GT_prior_use = None
    n_donor_use = int(n_donor + n_extra_donor)
    if GT_prior is not None and n_donor_use == GT_prior.shape[1]:
        GT_prior_use = GT_prior.copy()
    elif GT_prior is not None and n_donor_use < GT_prior.shape[1]:
        GT_prior_use = GT_prior.copy()
        n_donor_use = GT_prior.shape[1]

    cfg_kwargs = dict(kwargs)
    cfg = VireoConfig(n_var=counts.n_var, n_cell=counts.n_cell,
                      n_donor=n_donor_use, learn_GT=learn_GT,
                      **{k: v for k, v in cfg_kwargs.items()
                         if k in ("n_GT", "learn_theta", "ASE_mode",
                                  "fix_beta_sum")})
    priors = default_priors(cfg, GT_prior=GT_prior_use, dtype=dtype)

    # ---- warm restarts: one vmapped device call (vireo_wrap.py:64-87)
    if resume is not None:
        # skip the completed phase; the saved host-RNG position keeps
        # later draws (refit inits, ambient dirichlet) stream-identical
        best_state, _, ex = ckpt.load_state(checkpoint_dir, 0,
                                            dtype=dtype)
        elbo_all = np.asarray(ex["elbo_all"])
        ckpt.load_rng(checkpoint_dir, "rng_0")
    else:
        with phase("warm_restarts"):
            if device_init:
                # unseeded runs stay run-to-run random (reference
                # semantics: inits ride the global np stream) by
                # deriving the device key from that stream
                dseed = random_seed if random_seed is not None \
                    else int(rng.randint(2 ** 31))
                batched = _device_batched_init(cfg, n_init, dseed,
                                               GT_prior_use, dtype)
            else:
                # draws at the TRUE cell count (padded cells carry zero
                # counts — their posterior is the prior after one step
                # regardless of init), so the host RNG stream matches
                # an unpadded run of the same seed
                batched = _seeded_batched_init(cfg, n_init,
                                               GT_prior_use, rng, dtype,
                                               n_cell_draw=n_cell_in)
            if mesh is not None and isinstance(counts, DenseCounts):
                # place the (R, C, K) assignment batch cell-sharded next
                # to the data; the (R, V, K, G) genotype batch follows
                # the variant axis on a 2-D mesh; theta stays replicated
                from jax.sharding import NamedSharding, PartitionSpec as P
                from ..parallel.mesh import CELL_AXIS, VAR_AXIS
                id_sh = NamedSharding(mesh, P(None, CELL_AXIS, None))
                batched = dataclasses.replace(
                    batched,
                    id_prob=jax.device_put(batched.id_prob, id_sh))
                if VAR_AXIS in mesh.axis_names:
                    gt_sh = NamedSharding(
                        mesh, P(None, VAR_AXIS, None, None))
                    batched = dataclasses.replace(
                        batched,
                        gt_prob=jax.device_put(batched.gt_prob, gt_sh))
            best_state, elbo_dev, binom_dev = _warm_select(
                counts, batched, priors, cfg, max_iter_init,
                delay_fit_theta)
            # reference-style reported values: f64 host addition of the
            # binomial constant (selection already happened on device —
            # the winner slice never fetches the (R, C, K) batch)
            elbo_all = np.asarray(jax.device_get(elbo_dev)) \
                + float(jax.device_get(binom_dev))
        if checkpoint_dir:
            ckpt.save_state(checkpoint_dir, 0, best_state,
                            extra={"elbo_all": elbo_all},
                            fingerprint=run_fp)
            ckpt.save_rng(checkpoint_dir, "rng_0")

    if resume is not None and resume >= 1:
        state1, priors1, ex1 = ckpt.load_state(checkpoint_dir, 1,
                                               dtype=dtype)
        ckpt.load_rng(checkpoint_dir, "rng_1")
        modelCA = _model_from_state(
            counts, cfg_kwargs, int(ex1["n_donor"]),
            bool(ex1["learn_GT"]), state1, None, dtype)
        modelCA.state = state1        # verbatim (init_state renormalizes)
        modelCA.priors = priors1      # branch-dependent GT prior
        modelCA.ELBO_ = np.asarray(ex1["ELBO_"])
        if verbose:
            print("[vireo] lower bound ranges [%.1f, %.1f, %.1f]"
                  % (np.min(elbo_all), np.median(elbo_all),
                     np.max(elbo_all)))
    else:
        with phase("model_build"):
            modelCA = _model_from_state(
                counts, cfg_kwargs, n_donor_use, learn_GT, best_state,
                GT_prior_use, dtype, device_state=device_init)
        modelCA.ELBO_ = np.asarray([elbo_all[np.argmax(elbo_all)]])

        # ---- long refit of the winner / extra-donor reduction
        # (vireo_wrap.py:89-105)
        with phase("refit"):
            if n_extra_donor == 0:
                modelCA.fit(counts, min_iter=5, verbose=False)
            else:
                _ID_prob = donor_select(modelCA.GT_prob, modelCA.ID_prob,
                                        n_donor, mode=extra_donor_mode,
                                        verbose=verbose)
                modelCA = Vireo(n_cell=counts.n_cell, n_var=counts.n_var,
                                n_donor=n_donor, learn_GT=learn_GT,
                                GT_prob_init=GT_prior_use,
                                ID_prob_init=_ID_prob,
                                beta_mu_init=modelCA.beta_mu,
                                beta_sum_init=modelCA.beta_sum,
                                dtype=dtype, **cfg_kwargs)
                modelCA.set_prior(GT_prior=GT_prior_use)
                modelCA.fit(counts, min_iter=5,
                            delay_fit_theta=delay_fit_theta,
                            verbose=False)

            if verbose:
                print("[vireo] lower bound ranges [%.1f, %.1f, %.1f]"
                      % (np.min(elbo_all), np.median(elbo_all),
                         np.max(elbo_all)))

            # ---- donor-subset prior: keep largest donors, refit fixed
            # (vireo_wrap.py:111-119)
            if GT_prior is not None and n_donor < GT_prior.shape[1]:
                _donor_cnt = host_fetch(
                    jnp.sum(modelCA.state.id_prob, axis=0))
                _donor_idx = np.argsort(_donor_cnt)[::-1]
                GT_prior_use = GT_prior[:, _donor_idx[:n_donor], :]

                # note: the reference deliberately keeps the DEFAULT
                # (uniform) GT prior here — only the init is pinned
                # (vireo_wrap.py:116-119)
                modelCA = Vireo(n_cell=counts.n_cell, n_var=counts.n_var,
                                n_donor=n_donor, learn_GT=False,
                                GT_prob_init=GT_prior_use, dtype=dtype,
                                **cfg_kwargs)
                modelCA.fit(counts, min_iter=20, verbose=False)

            # ---- donor-superset prior: graft known donors into slots
            # (vireo_wrap.py:121-136)
            elif GT_prior is not None and n_donor > GT_prior.shape[1]:
                GT_prior_use = modelCA.GT_prob.copy()
                idx = optimal_match(GT_prior, GT_prior_use)[1]
                GT_prior_use[:, idx, :] = GT_prior
                _idx_order = np.append(idx,
                                       np.delete(np.arange(n_donor), idx))
                GT_prior_use = GT_prior_use[:, _idx_order, :]
                ID_prob_use = modelCA.ID_prob[:, _idx_order]

                modelCA = Vireo(n_cell=counts.n_cell, n_var=counts.n_var,
                                n_donor=n_donor, learn_GT=learn_GT,
                                ID_prob_init=ID_prob_use,
                                beta_mu_init=modelCA.beta_mu,
                                beta_sum_init=modelCA.beta_sum,
                                GT_prob_init=GT_prior_use, dtype=dtype,
                                **cfg_kwargs)
                modelCA.set_prior(GT_prior=GT_prior_use)
                modelCA.fit(counts, min_iter=20, verbose=False)

        if checkpoint_dir:
            ckpt.save_state(checkpoint_dir, 1, modelCA.state,
                            priors=modelCA.priors,
                            extra={"elbo_all": elbo_all,
                                   "ELBO_": modelCA.ELBO_,
                                   "n_donor": modelCA.n_donor,
                                   "learn_GT": modelCA.config.learn_GT},
                            fingerprint=run_fp)
            ckpt.save_rng(checkpoint_dir, "rng_1")

    if verbose:
        print("[vireo] allelic rate mean and concentrations:")
        print(np.round(modelCA.beta_mu, 3))
        print(np.round(modelCA.beta_sum, 1))

        print("[vireo] donor size before removing doublets:")
        # reduce on device; fetching the whole (C, K) posterior for a
        # K-entry print would move ~6 MB
        _donor_cnt = host_fetch(jnp.sum(modelCA.state.id_prob, axis=0))
        print("\t".join(["donor%d" % x for x in range(len(_donor_cnt))]))
        print("\t".join(["%.0f" % x for x in _donor_cnt]))

    # ---- doublet prediction (vireo_wrap.py:150-156)
    n_donor_final = modelCA.n_donor
    if check_doublet:
        with phase("doublet"):
            # rate prior from the TRUE cell count (vireo_doublet.py:
            # 44-50) — mesh cell-padding must not inflate it
            doublet_prob, ID_prob, doublet_LLR = predict_doublet(
                modelCA, counts, None,
                doublet_rate_prior=min(0.5, n_cell_in / 100000))
    else:
        ID_prob = modelCA.ID_prob
        doublet_prob = np.zeros(
            (counts.n_cell, int(n_donor_final * (n_donor_final - 1) / 2)))
        doublet_LLR = np.zeros(counts.n_cell)

    theta_shapes = np.append(modelCA.beta_mu * modelCA.beta_sum,
                             (1 - modelCA.beta_mu) * modelCA.beta_sum,
                             axis=0)

    # ---- ambient RNA (vireo_wrap.py:161-168). `ambient_min_gain`
    # overrides the reference-parity SNP gate sqrt(n_cell)/3
    # (vireo_doublet.py:230-240), which barely filters at scale —
    # 27.5k/30k SNPs kept at the north star — so the phase cost is
    # nearly proportional to n_var; a higher gate trades coverage of
    # weakly-informative SNPs for time (see benchmarks/ambient_phase).
    if check_ambient:
        with phase("ambient"):
            ambient_Psi, Psi_var, Psi_logLik_ratio = predit_ambient(
                modelCA, counts, None, min_ELBO_gain=ambient_min_gain)
    else:
        ambient_Psi, Psi_var, Psi_logLik_ratio = None, None, None

    if timer is not None:
        print(timer.summary())

    RV = {}
    RV['ID_prob'] = host_fetch(ID_prob)
    RV['GT_prob'] = modelCA.GT_prob
    RV['doublet_LLR'] = host_fetch(doublet_LLR)
    RV['doublet_prob'] = host_fetch(doublet_prob)
    RV['theta_shapes'] = theta_shapes
    RV['theta_mean'] = modelCA.beta_mu
    RV['theta_sum'] = modelCA.beta_sum
    RV['ambient_Psi'] = ambient_Psi
    RV['Psi_var'] = Psi_var
    RV['Psi_LLRatio'] = Psi_logLik_ratio
    RV['LB_list'] = elbo_all
    RV['LB_doublet'] = modelCA.ELBO_[-1]
    if n_pad_cells:
        for key in ('ID_prob', 'doublet_prob', 'doublet_LLR',
                    'ambient_Psi', 'Psi_var', 'Psi_LLRatio'):
            if RV.get(key) is not None:
                RV[key] = np.asarray(RV[key])[:n_cell_in]
    return RV
