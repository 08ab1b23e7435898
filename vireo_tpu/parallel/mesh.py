"""Multi-chip execution: cell-sharded data-parallel EM over a Mesh.

The reference's only parallelism is a multiprocessing.Pool over
restarts plus manual --cellRange chunking (vireo_wrap.py:74-83,
vireo.py:136-142). Here the scaling axis is the cell dimension,
sharded across a `jax.sharding.Mesh`:

- AD/DP (COO triplets grouped by owning shard) and ID_prob live
  cell-sharded; GT_prob / theta are replicated;
- each EM iteration psums the (n_var x K) sufficient statistics and
  the scalar per-cell ELBO terms over the mesh (NVLink collectives) —
  ~n_var*K*8B per step, trivially small vs compute;
- the E-step is purely local to each shard.

Two paths are provided:
1. `fit_vb_auto`: dense counts + NamedSharding constraints; XLA's SPMD
   partitioner inserts the collectives (idiomatic pjit path).
2. `sharded_fit_vb`: explicit shard_map over per-shard COO chunks with
   lax.psum — the scalable sparse path, also used by dryrun.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.counts import DenseCounts, SparseCounts
from ..models.vireo import fit_vb, FitResult

__all__ = ["make_mesh", "make_mesh2d", "initialize_distributed",
           "fit_vb_auto", "warm_restarts_auto", "ShardedCounts",
           "build_cell_sharded_coo", "sharded_fit_vb", "count_spec",
           "n_cell_shards"]

CELL_AXIS = "cells"
VAR_AXIS = "vars"


def make_mesh(n_devices=None, devices=None, axis=CELL_AXIS):
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_mesh2d(n_var_shards, n_cell_shards=None, devices=None):
    """2-D (vars x cells) mesh: the capacity axis for pools whose
    (n_var x n_cell_shard) dense block exceeds one chip's HBM even at
    a nibble per count — the variant axis shards too, dividing the
    per-chip count bytes by BOTH mesh extents. GT_prob and the theta
    digamma tables follow the variant sharding under GSPMD; the
    per-iteration collectives become a cells-axis psum of the (V_shard,
    K) statistics plus a vars-axis psum of the (C_shard, K) logliks.

    The reference has no analog at any scale (SURVEY §5 long-context);
    1-D cell sharding (`make_mesh`) stays the default until the dense
    budget check fails.
    """
    if devices is None:
        devices = jax.devices()
    if n_cell_shards is None:
        n_cell_shards = len(devices) // n_var_shards
    n = n_var_shards * n_cell_shards
    assert n <= len(devices), (
        "mesh %dx%d needs %d devices, have %d"
        % (n_var_shards, n_cell_shards, n, len(devices)))
    grid = np.array(devices[:n]).reshape(n_var_shards, n_cell_shards)
    return Mesh(grid, (VAR_AXIS, CELL_AXIS))


def count_spec(mesh):
    """PartitionSpec for the (n_var, n_cell) count matrices on `mesh`:
    cells always shard; variants shard too when the mesh has a vars
    axis (2-D capacity layout)."""
    var_ax = VAR_AXIS if VAR_AXIS in mesh.axis_names else None
    return P(var_ax, CELL_AXIS)


def n_cell_shards(mesh):
    """Number of shards along the cell axis (1-D: every device)."""
    return int(mesh.shape[CELL_AXIS])


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Multi-host bring-up: `jax.distributed.initialize` with env-var
    fallbacks, after which `jax.devices()` spans every process and
    `make_mesh()` builds the global cell mesh (NVLink within a host,
    the network across hosts — the per-iteration psum payload is only
    ~n_var * n_donor * 8B).

    No-ops when already initialized or on a single process.
    """
    import os
    coordinator_address = (coordinator_address
                           or os.environ.get("VIREO_COORDINATOR"))
    if coordinator_address is None and num_processes is None:
        return False
    # cross-process CPU collectives need an explicit transport; must be
    # set before the backend initializes (so no jax.default_backend()
    # probe here — read the configured platform string instead)
    plat = (jax.config.jax_platforms or
            os.environ.get("JAX_PLATFORMS", ""))
    if "cpu" in str(plat):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return True


def _put_global(mesh, x, spec):
    """Assemble a process-replicated host array into a global device
    array with the given PartitionSpec. Works identically in single-
    and multi-process runs (every process holds the full host copy and
    serves whatever index shards land on its local devices)."""
    x = np.asarray(x)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


# ---------------------------------------------------------------------
# Path 1: dense counts, XLA auto-partitioning
# ---------------------------------------------------------------------

def fit_vb_auto(mesh, counts, state, priors, cfg, **fit_kwargs):
    """Shard dense counts over the mesh (cells, plus variants on a 2-D
    mesh), shard ID_prob over cells and GT_prob over variants, and let
    the SPMD partitioner insert the all-reduces."""
    assert isinstance(counts, DenseCounts), "auto path expects DenseCounts"
    spec = count_spec(mesh)
    var_ax = spec[0]                                       # None on 1-D
    cnt_sh = NamedSharding(mesh, spec)                     # (V, C)
    id_sh = NamedSharding(mesh, P(CELL_AXIS, None))        # (C, K)
    gt_sh = NamedSharding(mesh, P(var_ax, None, None))     # (V, K, G)
    rep = NamedSharding(mesh, P())

    def theta_sh(x):
        # (theta_len, G): per-variant only in ASE mode
        ax = var_ax if x.shape[0] == cfg.n_var else None
        return NamedSharding(mesh, P(ax, None))

    counts = DenseCounts(jax.device_put(counts.ad, cnt_sh),
                         jax.device_put(counts.dp, cnt_sh))
    state = dataclasses.replace(
        state,
        id_prob=jax.device_put(state.id_prob, id_sh),
        gt_prob=jax.device_put(state.gt_prob, gt_sh),
        beta_mu=jax.device_put(state.beta_mu, theta_sh(state.beta_mu)),
        beta_sum=jax.device_put(state.beta_sum,
                                theta_sh(state.beta_sum)))
    priors = dataclasses.replace(
        priors,
        theta_s1=jax.device_put(priors.theta_s1,
                                theta_sh(priors.theta_s1)),
        theta_s2=jax.device_put(priors.theta_s2,
                                theta_sh(priors.theta_s2)),
        id_log=jax.device_put(priors.id_log, rep),
        gt_log=jax.device_put(
            priors.gt_log,
            gt_sh if priors.gt_log.shape[0] == cfg.n_var else rep))
    return fit_vb(counts, state, priors, cfg, **fit_kwargs)


def warm_restarts_auto(mesh, counts, states_batched, priors, cfg,
                       shard_axis="cells", **fit_kwargs):
    """Multi-init warm fits on a mesh. Two fan-out layouts:

    - shard_axis="cells" (default): counts/ID_prob sharded over cells,
      the restart axis vmapped — XLA batches the per-restart matrix
      products while reading the data once, inserting the
      per-iteration all-reduces. Right when the data dominates device
      memory.
    - shard_axis="restarts": data replicated, the restart batch split
      across devices — zero per-iteration communication (each device
      fits its own restarts; the best-ELBO argmax happens on the
      gathered vector afterwards). Right when data is small and
      restarts are many (the reference's Pool-over-restarts,
      vireo_wrap.py:74-83, mapped to chips).
    """
    assert isinstance(counts, DenseCounts), "auto path expects DenseCounts"
    if shard_axis == "restarts":
        rep = NamedSharding(mesh, P())
        restart_sh = NamedSharding(mesh, P(CELL_AXIS))  # leading R axis
        counts = DenseCounts(jax.device_put(counts.ad, rep),
                             jax.device_put(counts.dp, rep))
        states_batched = jax.tree.map(
            lambda x: jax.device_put(
                x, NamedSharding(mesh, P(*((CELL_AXIS,)
                                           + (None,) * (x.ndim - 1))))),
            states_batched)
        del restart_sh
        priors = jax.tree.map(lambda x: jax.device_put(x, rep), priors)
        return jax.vmap(lambda st: fit_vb(counts, st, priors, cfg,
                                          **fit_kwargs))(states_batched)

    cell_sh = NamedSharding(mesh, P(None, CELL_AXIS))
    id_sh = NamedSharding(mesh, P(None, CELL_AXIS, None))  # (R, C, K)
    rep = NamedSharding(mesh, P())

    counts = DenseCounts(jax.device_put(counts.ad, cell_sh),
                         jax.device_put(counts.dp, cell_sh))
    states_batched = dataclasses.replace(
        states_batched,
        id_prob=jax.device_put(states_batched.id_prob, id_sh),
        gt_prob=jax.device_put(states_batched.gt_prob, rep),
        beta_mu=jax.device_put(states_batched.beta_mu, rep),
        beta_sum=jax.device_put(states_batched.beta_sum, rep))
    priors = jax.tree.map(lambda x: jax.device_put(x, rep), priors)
    return jax.vmap(lambda st: fit_vb(counts, st, priors, cfg,
                                      **fit_kwargs))(states_batched)


# ---------------------------------------------------------------------
# Path 2: explicit shard_map over per-shard COO chunks
# ---------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedCounts:
    """A shard-local Counts whose variant-side reductions psum over the
    mesh axis. Valid only inside shard_map/pjit with that axis bound."""
    local: SparseCounts
    axis: str = dataclasses.field(metadata=dict(static=True))

    @property
    def n_var(self):
        return self.local.n_var

    @property
    def n_cell(self):
        return self.local.n_cell

    def suff_stats(self, W):
        S1, SS = self.local.suff_stats(W)
        return jax.lax.psum((S1, SS), self.axis)

    def cell_loglik(self, Wa, Wd):
        return self.local.cell_loglik(Wa, Wd)

    def binom_coeff_sum(self):
        return jax.lax.psum(self.local.binom_coeff_sum(), self.axis)

    def row_sums(self):
        a, d = self.local.row_sums()
        return jax.lax.psum((a, d), self.axis)

    def n_vars_per_cell(self):
        return self.local.n_vars_per_cell()


def build_cell_sharded_coo(AD, DP, n_shards, dtype=np.float32,
                           pad_multiple=1024):
    """Host-side: split cells into `n_shards` equal ranges and pack each
    range's COO triplets (local cell indices) into equal-size padded
    blocks, concatenated so an even nnz-axis sharding gives each device
    exactly its own cells.

    Returns (arrays dict, meta dict).
    """
    import scipy.sparse as sp
    A = sp.csc_matrix(AD)
    D = sp.csc_matrix(DP)
    n_var, n_cell = A.shape
    c_local = -(-n_cell // n_shards)          # cells per shard (padded)
    n_cell_pad = c_local * n_shards

    # per-shard COO extraction
    blocks = []
    max_nnz = 0
    for s in range(n_shards):
        lo, hi = s * c_local, min((s + 1) * c_local, n_cell)
        Ab = sp.coo_matrix(A[:, lo:hi])
        Db = sp.coo_matrix(D[:, lo:hi])
        Du = sp.csr_matrix(
            (np.ones_like(Ab.data), (Ab.row, Ab.col)),
            shape=(n_var, hi - lo)) + sp.csr_matrix(
            (np.ones_like(Db.data), (Db.row, Db.col)),
            shape=(n_var, hi - lo))
        U = Du.tocoo()
        rows, cols = U.row.astype(np.int64), U.col.astype(np.int64)
        a = np.asarray(sp.csr_matrix(Ab)[rows, cols]).reshape(-1)
        d = np.asarray(sp.csr_matrix(Db)[rows, cols]).reshape(-1)
        blocks.append((rows, cols, a, d))
        max_nnz = max(max_nnz, len(rows))

    nnz_pad = -(-max(max_nnz, 1) // pad_multiple) * pad_multiple

    def pack(order_key):
        out = {k: [] for k in ("rows", "cols", "ad", "dp", "ptr")}
        n_seg = n_var if order_key == "row" else c_local
        for rows, cols, a, d in blocks:
            order = (np.lexsort((cols, rows)) if order_key == "row"
                     else np.lexsort((rows, cols)))
            r = np.zeros(nnz_pad, np.int32)
            c = np.zeros(nnz_pad, np.int32)
            av = np.zeros(nnz_pad, dtype)
            dv = np.zeros(nnz_pad, dtype)
            n = len(rows)
            r[:n] = rows[order]
            c[:n] = cols[order]
            av[:n] = a[order]
            dv[:n] = d[order]
            out["rows"].append(r)
            out["cols"].append(c)
            out["ad"].append(av)
            out["dp"].append(dv)
            # per-shard segment boundaries over the real prefix
            sorted_ids = (rows if order_key == "row" else cols)[order]
            out["ptr"].append(np.searchsorted(
                sorted_ids, np.arange(n_seg + 1)).astype(np.int32))
        return {k: np.concatenate(v) for k, v in out.items()}

    by_row = pack("row")
    by_col = pack("col")
    arrays = dict(
        rows_r=by_row["rows"], cols_r=by_row["cols"],
        ad_r=by_row["ad"], dp_r=by_row["dp"],
        rows_c=by_col["rows"], cols_c=by_col["cols"],
        ad_c=by_col["ad"], dp_c=by_col["dp"],
        row_ptr=by_row["ptr"], col_ptr=by_col["ptr"],
    )
    meta = dict(n_var=n_var, n_cell=n_cell, n_cell_pad=n_cell_pad,
                c_local=c_local, n_shards=n_shards, nnz_pad=nnz_pad)
    return arrays, meta


def build_cell_sharded_dense(AD, DP, n_shards, dtype=np.int8):
    """Host-side: split cells into `n_shards` equal (padded) ranges and
    densify each range into the target dtype — the dense analog of
    `build_cell_sharded_coo`, for multi-process runs where the
    per-process block fits memory. int8 requires max count <= 127 (the
    caller checks; values clip to saturate).

    Returns (ad, dp, meta): (n_var, n_cell_pad) host arrays whose even
    cell sharding gives each process exactly its own cell range.
    """
    import scipy.sparse as sp
    A = sp.csc_matrix(AD)
    D = sp.csc_matrix(DP)
    n_var, n_cell = A.shape
    c_local = -(-n_cell // n_shards)
    n_cell_pad = c_local * n_shards

    ad = np.zeros((n_var, n_cell_pad), dtype)
    dp = np.zeros((n_var, n_cell_pad), dtype)
    clip = 127 if np.dtype(dtype) == np.int8 else None
    for s in range(n_shards):
        lo, hi = s * c_local, min((s + 1) * c_local, n_cell)
        a = np.asarray(A[:, lo:hi].todense())
        d = np.asarray(D[:, lo:hi].todense())
        if clip:
            a = np.minimum(a, clip)
            d = np.minimum(d, clip)
        ad[:, lo:hi] = a
        dp[:, lo:hi] = d
    meta = dict(n_var=n_var, n_cell=n_cell, n_cell_pad=n_cell_pad,
                c_local=c_local, n_shards=n_shards)
    return ad, dp, meta


def sharded_fit_vb_dense(mesh, ad, dp, meta, state, priors, cfg,
                         **fit_kwargs):
    """shard_map the full VB fit over cell-sharded DENSE blocks — the
    multi-process dense path (each process owns a contiguous cell
    range as a dense block; variant-side statistics psum
    over the mesh axis exactly like the COO path, ~n_var * K floats
    per iteration).

    `state.id_prob` must be (n_cell_pad, K); padded cells carry zero
    counts and contribute exactly zero to the data terms.
    """
    from jax import shard_map

    axis = CELL_AXIS
    state_spec = dataclasses.replace(
        state,
        id_prob=P(axis, None), gt_prob=P(), beta_mu=P(), beta_sum=P())
    in_specs = (P(None, axis), P(None, axis), state_spec,
                jax.tree.map(lambda _: P(), priors))
    out_specs = FitResult(
        state=state_spec,
        elbo_ref=P(), elbo_final=P(), n_iter=P(), elbo_trace=P())

    def run(ad_l, dp_l, st, pr):
        sc = ShardedCounts(local=DenseCounts(ad_l, dp_l), axis=axis)
        return fit_vb(sc, st, pr, cfg, axis_name=axis, **fit_kwargs)

    fn = shard_map(run, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    ad_dev = _put_global(mesh, ad, P(None, CELL_AXIS))
    dp_dev = _put_global(mesh, dp, P(None, CELL_AXIS))
    state_dev = dataclasses.replace(
        state,
        id_prob=_put_global(mesh, state.id_prob, P(CELL_AXIS, None)),
        gt_prob=_put_global(mesh, state.gt_prob, P()),
        beta_mu=_put_global(mesh, state.beta_mu, P()),
        beta_sum=_put_global(mesh, state.beta_sum, P()))
    priors_dev = jax.tree.map(lambda x: _put_global(mesh, x, P()), priors)
    return fn(ad_dev, dp_dev, state_dev, priors_dev)


def sharded_fit_vb(mesh, arrays, meta, state, priors, cfg, **fit_kwargs):
    """shard_map the full VB fit over cell-sharded COO chunks.

    `state.id_prob` must be (n_cell_pad, K); padded cells carry zero
    counts and contribute exactly zero to the ELBO.
    """
    from jax import shard_map

    c_local = meta["c_local"]
    n_var = meta["n_var"]
    axis = CELL_AXIS

    coo_spec = P(axis)
    in_specs = (
        {k: coo_spec for k in arrays},
        # state: id_prob cell-sharded, the rest replicated
        dataclasses.replace(
            state,
            id_prob=P(axis, None), gt_prob=P(), beta_mu=P(), beta_sum=P()),
        jax.tree.map(lambda _: P(), priors),
    )
    out_specs = FitResult(
        state=dataclasses.replace(
            state,
            id_prob=P(axis, None), gt_prob=P(), beta_mu=P(), beta_sum=P()),
        elbo_ref=P(), elbo_final=P(), n_iter=P(), elbo_trace=P())

    def run(arrs, st, pr):
        local = SparseCounts(
            rows_r=arrs["rows_r"], cols_r=arrs["cols_r"],
            ad_r=arrs["ad_r"], dp_r=arrs["dp_r"],
            rows_c=arrs["rows_c"], cols_c=arrs["cols_c"],
            ad_c=arrs["ad_c"], dp_c=arrs["dp_c"],
            shape=(n_var, c_local), nnz=meta["nnz_pad"],
            row_ptr=arrs["row_ptr"], col_ptr=arrs["col_ptr"])
        sc = ShardedCounts(local=local, axis=axis)
        return fit_vb(sc, st, pr, cfg, axis_name=axis, **fit_kwargs)

    fn = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    # global placement (multi-process safe): COO chunks sharded over
    # cells, id_prob cell-sharded, parameters/priors replicated
    arrays_dev = {k: _put_global(mesh, v, P(CELL_AXIS))
                  for k, v in arrays.items()}
    state_dev = dataclasses.replace(
        state,
        id_prob=_put_global(mesh, state.id_prob, P(CELL_AXIS, None)),
        gt_prob=_put_global(mesh, state.gt_prob, P()),
        beta_mu=_put_global(mesh, state.beta_mu, P()),
        beta_sum=_put_global(mesh, state.beta_sum, P()))
    priors_dev = jax.tree.map(lambda x: _put_global(mesh, x, P()), priors)
    return fn(arrays_dev, state_dev, priors_dev)
