"""Allele-count matrix abstraction: the device-side data substrate.

The reference holds AD/DP as scipy CSC matrices and performs ~6 separate
spMMs per EM iteration (vireo_model.py:165-219). Here every model-side
use of the data is reduced to exactly two fused contractions:

- ``suff_stats(W)``:   (S1, SS) = (AD @ W, DP @ W)       — variant-side
- ``cell_loglik(Wa, Wd)``: AD.T @ Wa + DP.T @ Wd         — cell-side

(The reference's ``BD = DP - AD`` terms fold algebraically into Wa/Wd,
collapsing its 3 transposed spMMs per genotype category into one pass.)

Two interchangeable backends, both registered pytrees so they can be
closed over / donated through jit:

- ``DenseCounts`` — (n_var, n_cell) dense arrays; contractions are
  matrix products. Optimal at demo scale and for moderately dense
  matrices.
- ``SparseCounts`` — padded COO triplets kept in BOTH row-major and
  col-major order, so each contraction is a gather + one
  ``segment_sum`` with sorted segment ids. Work is O(nnz * K).

Construction happens on host (numpy / scipy); device code never sees
scipy types.
"""

import dataclasses
import math as _pymath
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .math import log_binom_coeff
from ..utils.fetch import host_put

__all__ = [
    "Counts", "DenseCounts", "SparseCounts", "HybridCounts",
    "dense_counts", "sparse_counts", "counts_from_scipy",
    "hybrid_from_coo", "exact_count_dtype", "device_dense_budget",
]


# count bytes per row block of a dense contraction: each block is
# widened to the weights' float type for the product, so that temporary
# stays a few hundred MB whatever the pool size
ROW_BLOCK_BYTES = 1 << 25


def fold_rows(fn, init, *row_args):
    """acc = fn(start, *blocks, acc) over blocks of variant rows of the
    (n_var, ...) arrays `row_args`; the first (a count matrix) sets the
    block height from ROW_BLOCK_BYTES."""
    V, n_col = row_args[0].shape
    row_bytes = max(n_col * row_args[0].dtype.itemsize, 1)
    R = max(1, min(V, ROW_BLOCK_BYTES // row_bytes))
    n_full = V // R

    def body(i, acc):
        lo = i * R
        return fn(lo, *[jax.lax.dynamic_slice_in_dim(x, lo, R, 0)
                        for x in row_args], acc)

    acc = init
    if n_full:
        acc = jax.lax.fori_loop(0, n_full, body, acc)
    if V - n_full * R:
        lo = n_full * R
        acc = fn(lo, *[x[lo:] for x in row_args], acc)
    return acc


def count_dot(x, W):
    """x @ W for a block of counts x, exact to W's float type.

    Counts are exact integers in any float type, so the block is cast
    to W's dtype and contracted at HIGHEST precision. At the GPU's
    default precision (tensor cores) the same product was 1.4e-5
    relative off exact f32 — with W split into bf16-exact parts too —
    and a 30-iteration EM fit at 30k x 100k x 16 on an H100 then ended
    1.9e-3 relative off the exact-f32 ELBO with a non-monotone ELBO
    trace (chip_smoke.py phase 3).
    """
    return jnp.dot(x.astype(W.dtype), W, preferred_element_type=W.dtype,
                   precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseCounts:
    """Dense AD/DP counts of shape (n_var, n_cell)."""
    ad: jax.Array
    dp: jax.Array

    @property
    def n_var(self):
        return self.ad.shape[0]

    @property
    def n_cell(self):
        return self.ad.shape[1]

    def suff_stats(self, W):
        """(AD @ W, DP @ W) for W of shape (n_cell, K) -> two (n_var, K)."""
        def fn(lo, a, d, acc):
            put = jax.lax.dynamic_update_slice_in_dim
            return (put(acc[0], count_dot(a, W), lo, 0),
                    put(acc[1], count_dot(d, W), lo, 0))

        z = jnp.zeros((self.n_var, W.shape[1]), W.dtype)
        return fold_rows(fn, (z, z), self.ad, self.dp)

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd for (n_var, K) weights -> (n_cell, K)."""
        def fn(lo, a, d, wa, wd, acc):
            return acc + count_dot(a.T, wa) + count_dot(d.T, wd)

        z = jnp.zeros((self.n_cell, Wa.shape[1]), Wa.dtype)
        return fold_rows(fn, z, self.ad, self.dp, Wa, Wd)

    def binom_coeff_sum(self):
        """Sum of log C(DP, AD) over DP>0 entries (vireo_base.py:7-22).

        Chunked + jitted: the elementwise gammaln over a 30k x 100k
        dense matrix would otherwise materialize several matrix-sized
        f32 temporaries when called eagerly."""
        return _dense_binom_coeff_sum(self.dp, self.ad)

    def row_sums(self):
        """(AD.sum(axis=1), DP.sum(axis=1)) -> two (n_var,)."""
        return jnp.sum(self.ad, axis=1), jnp.sum(self.dp, axis=1)

    def n_vars_per_cell(self):
        """Number of variants with DP > 0 per cell (vireo.py:191)."""
        return jnp.sum(self.dp > 0, axis=0)

    def cell_slice(self, start, stop):
        return DenseCounts(self.ad[:, start:stop], self.dp[:, start:stop])

    def var_subset(self, idx):
        return DenseCounts(self.ad[idx, :], self.dp[idx, :])

    def densify(self):
        return self


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseCounts:
    """Padded COO counts in dual sort order.

    `*_r` arrays are sorted by (row, col); `*_c` by (col, row). Padding
    entries carry ad = dp = 0 and index 0, so they contribute nothing.
    """
    rows_r: jax.Array
    cols_r: jax.Array
    ad_r: jax.Array
    dp_r: jax.Array
    rows_c: jax.Array
    cols_c: jax.Array
    ad_c: jax.Array
    dp_c: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # CSR/CSC-style segment boundaries of the two sort orders. When
    # present, the contractions reduce via per-block cumsum + boundary
    # differences instead of segment_sum (no scatter; see
    # benchmarks/coo_micro.py to compare the two on a device).
    row_ptr: jax.Array = None   # (n_var + 1,) into the row-sorted copy
    col_ptr: jax.Array = None   # (n_cell + 1,) into the col-sorted copy

    @property
    def n_var(self):
        return self.shape[0]

    @property
    def n_cell(self):
        return self.shape[1]

    # gather/segment-sum contractions run in nnz blocks: unchunked, the
    # (nnz, 2K) gather temporaries alone are ~4 GB at 100k cells (nnz
    # ~30M, K=16) and several of them live at once. Blocks keep the
    # live set ~100 MB while the (n_var/n_cell, K) accumulators stay
    # small.
    NNZ_BLOCK = 1 << 21

    def _blocked(self, contrib_fn, seg_ids, ptr, num_segments, out_cols,
                 dtype):
        """sum_i reduce(contrib_fn(slice_i)) into (num_segments, out_cols).

        seg_ids is globally sorted, so every slice is sorted too. With
        segment boundaries `ptr` available, each block reduces via
        two-level compensated prefix sums + per-segment boundary
        differences (clamped into the block) — no scatter at all, and
        cancellation bounded at ~eps * 128 * max|contrib| (see
        `_interval_sums`); otherwise a sorted segment_sum.
        """
        n = seg_ids.shape[0]
        block = min(self.NNZ_BLOCK, n)
        n_full = n // block

        if ptr is None:
            def reduce_block(lo, m, acc):
                ids = jax.lax.dynamic_slice_in_dim(seg_ids, lo, m)
                return acc + jax.ops.segment_sum(
                    contrib_fn(lo, m), ids,
                    num_segments=num_segments, indices_are_sorted=True)
        else:
            def reduce_block(lo, m, acc):
                b_lo = jnp.clip(ptr[:-1] - lo, 0, m)
                b_hi = jnp.clip(ptr[1:] - lo, 0, m)
                return acc + _interval_sums(contrib_fn(lo, m), b_lo, b_hi)

        acc = jnp.zeros((num_segments, out_cols), dtype)
        if n_full:
            acc = jax.lax.fori_loop(
                0, n_full, lambda i, a: reduce_block(i * block, block, a),
                acc)
        rem = n - n_full * block
        if rem:
            acc = reduce_block(n_full * block, rem, acc)
        return acc

    def suff_stats(self, W):
        K = W.shape[1]
        n = self.rows_r.shape[0]
        block = min(self.NNZ_BLOCK, n)
        n_full = n // block
        ptr = self.row_ptr

        def gathered(lo, m):
            c = jax.lax.dynamic_slice_in_dim(self.cols_r, lo, m)
            a = jax.lax.dynamic_slice_in_dim(self.ad_r, lo, m)
            d = jax.lax.dynamic_slice_in_dim(self.dp_r, lo, m)
            x = jnp.take(W, c, axis=0)                     # (m, K)
            return a[:, None] * x, d[:, None] * x

        if ptr is None:
            def reduce_block(lo, m, acc):
                ids = jax.lax.dynamic_slice_in_dim(self.rows_r, lo, m)
                xa, xd = gathered(lo, m)
                both = jnp.concatenate([xa, xd], axis=1)
                s = jax.ops.segment_sum(both, ids,
                                        num_segments=self.n_var,
                                        indices_are_sorted=True)
                return acc[0] + s[:, :K], acc[1] + s[:, K:]
        else:
            # two K-wide reductions sharing one gather
            def reduce_block(lo, m, acc):
                b_lo = jnp.clip(ptr[:-1] - lo, 0, m)
                b_hi = jnp.clip(ptr[1:] - lo, 0, m)
                xa, xd = gathered(lo, m)
                return (acc[0] + _interval_sums(xa, b_lo, b_hi),
                        acc[1] + _interval_sums(xd, b_lo, b_hi))

        acc = (jnp.zeros((self.n_var, K), W.dtype),
               jnp.zeros((self.n_var, K), W.dtype))
        if n_full:
            acc = jax.lax.fori_loop(
                0, n_full, lambda i, a: reduce_block(i * block, block, a),
                acc)
        rem = n - n_full * block
        if rem:
            acc = reduce_block(n_full * block, rem, acc)
        return acc

    def cell_loglik(self, Wa, Wd):
        K = Wa.shape[1]
        # ONE (V, 2K) gather instead of two (V, K) gathers: one index
        # read serves both weight matrices
        Wcat = jnp.concatenate([Wa, Wd], axis=1)

        def contrib(lo, m):
            r = jax.lax.dynamic_slice_in_dim(self.rows_c, lo, m)
            a = jax.lax.dynamic_slice_in_dim(self.ad_c, lo, m)
            d = jax.lax.dynamic_slice_in_dim(self.dp_c, lo, m)
            g = jnp.take(Wcat, r, axis=0)
            return a[:, None] * g[:, :K] + d[:, None] * g[:, K:]

        return self._blocked(contrib, self.cols_c, self.col_ptr,
                             self.n_cell, K, Wa.dtype)

    def binom_coeff_sum(self):
        return jnp.sum(log_binom_coeff(self.dp_r, self.ad_r))

    def row_sums(self):
        s = jax.ops.segment_sum(
            jnp.stack([self.ad_r, self.dp_r], axis=1), self.rows_r,
            num_segments=self.n_var, indices_are_sorted=True)
        return s[:, 0], s[:, 1]

    def n_vars_per_cell(self):
        return jax.ops.segment_sum(
            (self.dp_c > 0).astype(jnp.int32), self.cols_c,
            num_segments=self.n_cell, indices_are_sorted=True)

    def max_count(self):
        """Largest count value (host float) — the densify dtype guard."""
        return float(jnp.maximum(jnp.max(self.ad_r), jnp.max(self.dp_r)))

    def pack(self, clip=False):
        """Scatter the COO triplets directly into the 4-bit
        nibble-packed dense layout (ops/packed.py) without ever
        materializing a 1-byte-per-count matrix. Requires every count
        <= 15 (the ladder checks `max_count()` first) unless `clip`
        saturates larger values at 15 (the hybrid base layout, which
        carries the clipped remainder in a COO residual)."""
        return _pack_triplets(self.rows_r, self.cols_r, self.ad_r,
                              self.dp_r, self.shape, clip=clip)

    def densify(self, dtype=None, check_overflow=True, sharding=None):
        """Scatter the COO triplets into dense (n_var, n_cell) arrays on
        device without ever materializing a dense matrix on host.

        `dtype=bfloat16` (counts <= 256 exact) or `int8` (counts <= 127
        exact; half the device bytes) build the fast dense layouts.
        `check_overflow` (default) promotes the dtype when any count
        exceeds the exact range instead of silently truncating — real
        scRNA depth can exceed 127 at hot sites even when the bulk of
        the matrix is tiny.

        `sharding` (optional NamedSharding) builds the dense arrays
        directly into the sharded layout, avoiding a replicated
        matrix-sized intermediate on multi-device meshes.
        """
        dtype = dtype or self.ad_r.dtype
        if check_overflow and dtype in (jnp.int8, jnp.bfloat16):
            vmax = self.max_count()
            promoted = exact_count_dtype(vmax)
            if (dtype == jnp.int8 and vmax > 127) or \
                    (dtype == jnp.bfloat16 and vmax > 256):
                print("[vireo] counts up to %.0f exceed the exact range "
                      "of %s; using %s" % (vmax, jnp.dtype(dtype).name,
                                           jnp.dtype(promoted).name))
                dtype = promoted
        return _densify_triplets(self.rows_r, self.cols_r, self.ad_r,
                                 self.dp_r, self.shape, dtype,
                                 sharding=sharding)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HybridCounts:
    """Clipped dense/packed base + tiny COO residual of overflow deltas.

    Integer counts split linearly around a cap:

        X = min(X, cap) + max(X - cap, 0)

    so every linear contraction (suff_stats, cell_loglik, row_sums) is
    EXACTLY the base-layout contraction plus a COO contraction over the
    few entries that overflow the cap. Real scRNA count matrices are
    dominated by small counts (UMI depths of 1-5); entries above 127
    (int8 cap) or 15 (nibble cap) are a tiny tail, so the residual nnz
    is a small fraction of the total and the iteration costs about
    what the dense/packed rung costs REGARDLESS of the maximum count.
    This removes the count-magnitude restriction that would otherwise
    force large-count pools onto the pure-COO fallback (the reference
    has no analog: scipy spMM is magnitude-agnostic,
    vireoSNP/utils/vireo_model.py:165-219).

    The one non-linear reduction, sum log C(DP, AD), is handled by a
    scalar correction computed once at build time on the true values:
    ``binom_corr = sum_over_overflow[logC(true) - logC(clipped)]``.
    """
    base: object                  # DenseCounts (int8) or PackedCounts
    resid: SparseCounts           # overflow deltas, padded COO
    binom_corr: jax.Array         # 0-d: binom-coeff correction
    cap: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_var(self):
        return self.base.n_var

    @property
    def n_cell(self):
        return self.base.n_cell

    @property
    def resid_nnz(self):
        return self.resid.nnz

    def suff_stats(self, W):
        b1, b2 = self.base.suff_stats(W)
        r1, r2 = self.resid.suff_stats(W)
        return b1 + r1, b2 + r2

    def cell_loglik(self, Wa, Wd):
        return (self.base.cell_loglik(Wa, Wd)
                + self.resid.cell_loglik(Wa, Wd))

    def binom_coeff_sum(self):
        return self.base.binom_coeff_sum() + self.binom_corr

    def row_sums(self):
        ba, bd = self.base.row_sums()
        ra, rd = self.resid.row_sums()
        return ba + ra, bd + rd

    def n_vars_per_cell(self):
        # clip preserves the DP > 0 pattern (cap >= 1), so the base
        # count is already exact
        return self.base.n_vars_per_cell()

    def densify(self, dtype=jnp.float32):
        """Exact dense f32 counts (ambient path; small matrices only)."""
        b = self.base if isinstance(self.base, DenseCounts) \
            else self.base.densify()
        r = self.resid

        @jax.jit
        def add_resid(x, vals):
            # residual padding entries carry value 0 at (0, 0): no-ops
            return x.astype(dtype).at[r.rows_r, r.cols_r].add(
                vals.astype(dtype))

        return DenseCounts(add_resid(b.ad, r.ad_r),
                           add_resid(b.dp, r.dp_r))

    def var_subset(self, idx):
        """Subset variants WITHOUT densifying the full matrix: the base
        layout subsets on device; the (tiny) residual is re-filtered on
        host. The binomial correction is recomputed from the kept
        entries (true value = base + delta)."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        base = self.base.var_subset(jnp.asarray(idx))
        r = self.resid
        rows = np.asarray(jax.device_get(r.rows_r))
        cols = np.asarray(jax.device_get(r.cols_r))
        da = np.asarray(jax.device_get(r.ad_r), np.float64)
        dd = np.asarray(jax.device_get(r.dp_r), np.float64)
        pos = np.full(self.n_var, -1, np.int64)
        pos[idx] = np.arange(len(idx))
        keep = (pos[rows] >= 0) & ((da > 0) | (dd > 0))  # drop padding
        new_rows = pos[rows[keep]]
        new_cols = cols[keep]
        da, dd = da[keep], dd[keep]

        # true = clipped base value + delta at each kept position
        bd = base.densify() if not isinstance(base, DenseCounts) else base
        ba = np.asarray(jax.device_get(
            bd.ad[jnp.asarray(new_rows), jnp.asarray(new_cols)]),
            np.float64)
        bb = np.asarray(jax.device_get(
            bd.dp[jnp.asarray(new_rows), jnp.asarray(new_cols)]),
            np.float64)
        corr = float(np.sum(_np_log_binom_coeff(bb + dd, ba + da))
                     - np.sum(_np_log_binom_coeff(bb, ba)))

        resid = _sparse_from_triplets(
            new_rows, new_cols, da, dd, (len(idx), self.n_cell),
            pad_multiple=1024, with_ptr=False)
        corr_dtype = jnp.float64 if jax.config.jax_enable_x64 \
            else jnp.float32
        return HybridCounts(base=base, resid=resid,
                            binom_corr=jnp.asarray(corr, corr_dtype),
                            cap=self.cap)

    def cell_slice(self, start, stop):
        """Slice a cell range WITHOUT densifying the full matrix (the
        hybrid rung is selected precisely when the exact dense layout
        exceeds the HBM budget, so a full densify here would OOM the
        chip). The base layout slices on device; the (tiny) residual is
        re-filtered on host and the binomial correction recomputed from
        the kept entries (true value = base + delta)."""
        start, stop = int(start), int(stop)
        base = self.base.cell_slice(start, stop)
        r = self.resid
        rows = np.asarray(jax.device_get(r.rows_r))
        cols = np.asarray(jax.device_get(r.cols_r))
        da = np.asarray(jax.device_get(r.ad_r), np.float64)
        dd = np.asarray(jax.device_get(r.dp_r), np.float64)
        keep = (cols >= start) & (cols < stop) & ((da > 0) | (dd > 0))
        new_rows = rows[keep]
        new_cols = cols[keep] - start
        da, dd = da[keep], dd[keep]

        bd = base.densify() if not isinstance(base, DenseCounts) else base
        ba = np.asarray(jax.device_get(
            bd.ad[jnp.asarray(new_rows), jnp.asarray(new_cols)]),
            np.float64)
        bb = np.asarray(jax.device_get(
            bd.dp[jnp.asarray(new_rows), jnp.asarray(new_cols)]),
            np.float64)
        corr = float(np.sum(_np_log_binom_coeff(bb + dd, ba + da))
                     - np.sum(_np_log_binom_coeff(bb, ba)))

        resid = _sparse_from_triplets(
            new_rows, new_cols, da, dd, (self.n_var, stop - start),
            pad_multiple=1024, with_ptr=False)
        corr_dtype = jnp.float64 if jax.config.jax_enable_x64 \
            else jnp.float32
        return HybridCounts(base=base, resid=resid,
                            binom_corr=jnp.asarray(corr, corr_dtype),
                            cap=self.cap)


def _np_log_binom_coeff(dp, ad, max_val=700.0):
    """Host f64 mirror of ops.math.log_binom_coeff (same 700 clip,
    0 where dp == 0) for the hybrid build-time correction."""
    from scipy.special import gammaln
    dp = np.asarray(dp, np.float64)
    ad = np.asarray(ad, np.float64)
    val = gammaln(dp + 1.0) - gammaln(ad + 1.0) - gammaln(dp - ad + 1.0)
    val = np.minimum(val, max_val)
    return np.where(dp > 0, val, 0.0)


def _hybrid_from_triplets(rows, cols, ad_v, dp_v, shape, cap, kind,
                          sharding=None, pad_multiple=8192, base=None,
                          warn_total=None):
    """Build HybridCounts from host COO triplets (see hybrid_from_coo).

    `warn_total` overrides the residual-size warning's denominator —
    the native path passes only the OVERFLOW triplets plus a pre-built
    base, so the full union nnz must come from the caller."""
    ar = np.asarray(ad_v, np.float64)
    dr = np.asarray(dp_v, np.float64)
    rr = np.asarray(rows)
    cr = np.asarray(cols)
    m = (ar > cap) | (dr > cap)          # padding (0 values) never hits
    at, dt = ar[m], dr[m]
    corr = float(np.sum(_np_log_binom_coeff(dt, at))
                 - np.sum(_np_log_binom_coeff(np.minimum(dt, cap),
                                              np.minimum(at, cap))))
    # power-of-two residual padding: the fit program's shape depends on
    # the padded residual size, so coarse buckets keep the persistent
    # compile cache hot across datasets
    n_over = int(m.sum())
    if n_over > 0.1 * max(warn_total or len(ar), 1):
        print("[vireo] warning: %.0f%% of counts exceed the %s cap %d "
              "— the hybrid residual is unusually large and per-"
              "iteration cost grows with it"
              % (100 * n_over / (warn_total or len(ar)), kind, cap))
    pad_multiple = max(pad_multiple,
                       1 << int(np.ceil(np.log2(max(n_over, 1)))))
    resid = _sparse_from_triplets(
        rr[m], cr[m], np.maximum(at - cap, 0.0), np.maximum(dt - cap, 0.0),
        shape, pad_multiple=pad_multiple, with_ptr=False)

    if base is not None:
        pass
    elif kind == "int8":
        base = _densify_triplets(rr, cr, ar, dr, shape, jnp.int8,
                                 sharding=sharding)
    elif kind == "packed":
        base = _pack_triplets(rr, cr, ar, dr, shape, clip=True)
    else:
        raise ValueError("unknown hybrid base kind %r" % (kind,))

    if sharding is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        rep = NamedSharding(sharding.mesh, PartitionSpec())
        resid = jax.tree.map(lambda x: jax.device_put(x, rep), resid)

    corr_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return HybridCounts(base=base, resid=resid,
                        binom_corr=jnp.asarray(corr, corr_dtype),
                        cap=int(cap))


def hybrid_from_coo(coo, cap, kind, sharding=None, pad_multiple=8192,
                    base=None):
    """Build HybridCounts from full-precision COO triplets.

    `kind` selects the base layout: "int8" (cap 127) or "packed"
    (cap 15). `sharding` places a dense base cell-sharded on the mesh
    and replicates the (tiny) residual. A pre-built `base` (e.g. a
    MeshPackedCounts over clipped counts) overrides the kind-derived
    construction.
    """
    return _hybrid_from_triplets(
        jax.device_get(coo.rows_r), jax.device_get(coo.cols_r),
        jax.device_get(coo.ad_r), jax.device_get(coo.dp_r),
        coo.shape, cap, kind, sharding=sharding,
        pad_multiple=pad_multiple, base=base)


Counts = (DenseCounts, SparseCounts, HybridCounts)


# --------------------------------------------------------------------
# compensated prefix-sum interval reduction (the COO ptr fast path)
# --------------------------------------------------------------------

def _scatter_block():
    """nnz entries per device scatter call (VIREO_SCATTER_BLOCK lets
    tests shrink it to exercise the chunk loop on small data)."""
    return int(os.environ.get("VIREO_SCATTER_BLOCK", 1 << 19))


def _two_sum(a, b):
    """Knuth TwoSum: s = fl(a+b) and the exact rounding error e."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def _two_diff(a, b):
    """fl(a-b) and its exact error (TwoSum with negated b)."""
    s = a - b
    z = s - a
    e = (a - (s - z)) - (b + z)
    return s, e


def _comp_inclusive_scan(t):
    """Inclusive prefix sum of t along axis 0 as a double-f32
    (hi, lo) pair via an associative TwoSum scan — ~2^-48 effective
    precision at f32 storage/throughput."""
    def combine(x, y):
        s, e = _two_sum(x[0], y[0])
        lo = e + x[1] + y[1]
        hi = s + lo
        return hi, lo - (hi - s)
    return jax.lax.associative_scan(
        combine, (t, jnp.zeros_like(t)), axis=0)


_INNER_ROW = 128  # inner cumsum span; bounds f32 cancellation to
                  # ~eps * 128 * max|contrib| per boundary difference


def _interval_sums(x, b_lo, b_hi):
    """Per-segment sums of a sorted (m, K) contribution block given
    clamped segment boundaries b_lo/b_hi in [0, m].

    Replaces the naive full-block cumsum whose boundary differences
    cancel against a prefix of magnitude ~block_total (measured ~4.6
    abs error on f32 cell logliks at 320k nnz — advisor round-2
    finding). Two levels instead: a plain f32 cumsum inside rows of
    _INNER_ROW entries, a double-f32 compensated scan over the row
    totals, and exact TwoDiff differencing of the outer prefixes.
    """
    m, K = x.shape
    L = _INNER_ROW
    Q = -(-m // L)
    xr = jnp.pad(x, ((0, Q * L - m), (0, 0))).reshape(Q, L, K)
    inner_inc = jnp.cumsum(xr, axis=1)
    # exclusive inner prefix, with a zero row Q so a boundary at m
    # (m % L == 0) indexes inner 0 / outer total
    inner_ex = jnp.concatenate(
        [jnp.zeros((Q, 1, K), x.dtype), inner_inc[:, :-1]], axis=1)
    inner_flat = jnp.concatenate(
        [inner_ex.reshape(Q * L, K), jnp.zeros((L, K), x.dtype)])
    hi_inc, lo_inc = _comp_inclusive_scan(inner_inc[:, -1])
    z = jnp.zeros((1, K), x.dtype)
    outer_hi = jnp.concatenate([z, hi_inc])
    outer_lo = jnp.concatenate([z, lo_inc])

    def at(b):
        q = b // L
        return (jnp.take(outer_hi, q, axis=0),
                jnp.take(outer_lo, q, axis=0),
                jnp.take(inner_flat, b, axis=0))

    h1, l1, i1 = at(b_hi)
    h0, l0, i0 = at(b_lo)
    d, e = _two_diff(h1, h0)
    return d + (e + (l1 - l0) + (i1 - i0))


@jax.jit
def _dense_binom_coeff_sum(dp, ad, row_chunk=256):
    """sum(log C(dp, ad)) over a large dense matrix without matrix-
    sized temporaries: fori_loop over row blocks via dynamic_slice
    (a flat-reshape approach copies the whole int8 matrix — 3 GB at
    30k x 100k)."""
    n_var = dp.shape[0]
    row_chunk = min(row_chunk, max(n_var, 1))
    n_full = n_var // row_chunk

    def body(i, tot):
        d = jax.lax.dynamic_slice_in_dim(dp, i * row_chunk, row_chunk, 0)
        a = jax.lax.dynamic_slice_in_dim(ad, i * row_chunk, row_chunk, 0)
        return tot + jnp.sum(log_binom_coeff(d, a))

    acc_dtype = jax.eval_shape(
        log_binom_coeff,
        jax.ShapeDtypeStruct((1,), dp.dtype),
        jax.ShapeDtypeStruct((1,), ad.dtype)).dtype
    total = jnp.zeros((), acc_dtype)
    if n_full:
        total = jax.lax.fori_loop(0, n_full, body, total)
    if n_var - n_full * row_chunk:
        total = total + jnp.sum(
            log_binom_coeff(dp[n_full * row_chunk:],
                            ad[n_full * row_chunk:]))
    return total


def dense_counts(AD, DP, dtype=jnp.float32):
    """Build DenseCounts from numpy / scipy inputs."""
    AD = _to_dense_np(AD)
    DP = _to_dense_np(DP)
    return DenseCounts(jnp.asarray(AD, dtype=dtype), jnp.asarray(DP, dtype=dtype))


def _to_dense_np(X):
    if hasattr(X, "toarray"):
        return np.asarray(X.toarray())
    return np.asarray(X)


def _round_up(n, m):
    return int(_pymath.ceil(max(n, 1) / m) * m)


def _host_union_triplets(AD, DP):
    """Aligned host COO triplets over the union nonzero pattern of AD
    and DP: (rows int64, cols int64, ad_vals, dp_vals), canonically
    (row, col)-sorted with no duplicates.

    The union pattern comes from one indicator-matrix addition in
    scipy's C merge kernel; values align to it via a vectorized
    searchsorted over flattened (row * C + col) keys (both CSRs are
    canonical, so the key sequences are already sorted). The previous
    per-entry fancy-indexing lookup was ~26 s at 30M nnz; this path
    is a few seconds.
    """
    import scipy.sparse as sp

    def canon_csr(X):
        # csr_matrix(X) on a CSR input SHARES its buffers:
        # canonicalize a copy, never the caller's matrix
        M = sp.csr_matrix(X)
        if not M.has_canonical_format:
            M = M.copy()
            M.sum_duplicates()
        return M

    A = canon_csr(AD)
    D = canon_csr(DP)
    assert A.shape == D.shape, "AD and DP shapes differ"
    C = int(A.shape[1])
    if np.array_equal(A.indptr, D.indptr) and \
            np.array_equal(A.indices, D.indices):
        rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                         np.diff(A.indptr))
        return rows, A.indices.astype(np.int64), A.data, D.data

    native = _native_union(A, D)
    if native is not None:
        return native

    Ia = A.copy()
    Ia.data = np.ones_like(Ia.data)
    Id = D.copy()
    Id.data = np.ones_like(Id.data)
    U = Ia + Id                     # canonical CSR over the union
    rows = np.repeat(np.arange(U.shape[0], dtype=np.int64),
                     np.diff(U.indptr))
    cols = U.indices.astype(np.int64)
    key_u = rows * C + cols         # ascending (row-major canonical)

    def align(M):
        Mc = M.tocoo()              # canonical -> sorted keys
        key = Mc.row.astype(np.int64) * C + Mc.col
        out = np.zeros(len(key_u), dtype=np.float64)
        out[np.searchsorted(key_u, key)] = Mc.data
        return out

    return rows, cols, align(A), align(D)


def _native_union(A, D):
    """One-pass C++ union merge of two canonical CSRs (the scipy
    indicator-add + searchsorted path above costs ~7-19 s at 30M nnz
    on this host; the merge is ~0.5 s). None when the native library
    is unavailable (caller falls back)."""
    import ctypes
    from ..io._native import lib as native_lib
    nat = native_lib()
    if nat is None:
        return None
    A.sort_indices()
    D.sort_indices()
    a_indptr = np.ascontiguousarray(A.indptr, np.int64)
    d_indptr = np.ascontiguousarray(D.indptr, np.int64)
    a_indices = np.ascontiguousarray(A.indices, np.int32)
    d_indices = np.ascontiguousarray(D.indices, np.int32)
    a_data = np.ascontiguousarray(A.data, np.float64)
    d_data = np.ascontiguousarray(D.data, np.float64)

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def p(x, t):
        return x.ctypes.data_as(t)

    n_row = int(A.shape[0])
    nnz = nat.union_csr(n_row, p(a_indptr, i64p), p(a_indices, i32p),
                        p(a_data, f64p), p(d_indptr, i64p),
                        p(d_indices, i32p), p(d_data, f64p),
                        None, None, None, None)
    if nnz < 0:
        return None
    rows = np.empty(nnz, np.int32)
    cols = np.empty(nnz, np.int32)
    av = np.empty(nnz, np.float64)
    dv = np.empty(nnz, np.float64)
    got = nat.union_csr(n_row, p(a_indptr, i64p), p(a_indices, i32p),
                        p(a_data, f64p), p(d_indptr, i64p),
                        p(d_indices, i32p), p(d_data, f64p),
                        p(rows, i32p), p(cols, i32p), p(av, f64p),
                        p(dv, f64p))
    if got != nnz:
        return None
    # int32 indices: every consumer casts to its own dtype anyway
    return rows, cols, av, dv


def sparse_counts(AD, DP, dtype=jnp.float32, pad_multiple=8192):
    """Build SparseCounts over the union nonzero pattern of AD and DP.

    nnz is padded up to a multiple of `pad_multiple` so jit caches are
    reused across datasets of similar size.

    VIREO_COO_EXACT=1 drops the segment-boundary pointers so every
    contraction reduces via sorted `segment_sum` instead of the
    compensated prefix-sum fast path (an escape hatch for auditing the
    reduction numerics).
    """
    rows, cols, ad_vals, dp_vals = _host_union_triplets(AD, DP)
    return _sparse_from_triplets(rows, cols, ad_vals, dp_vals,
                                 tuple(np.shape(AD)), dtype=dtype,
                                 pad_multiple=pad_multiple)


def _sparse_from_triplets(rows, cols, ad_vals, dp_vals, shape,
                          dtype=jnp.float32, pad_multiple=8192,
                          with_ptr=None):
    """Build SparseCounts from host COO triplets (no de-duplication:
    (row, col) pairs must be unique).

    `with_ptr=False` skips the segment-boundary pointers so the
    contractions use one fused sorted segment_sum — faster for SMALL
    nnz (e.g. hybrid residuals), where the compensated prefix-sum
    path's fixed per-call costs dominate its asymptotic win."""
    n_var, n_cell = shape
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nnz = len(rows)
    nnz_pad = _round_up(nnz, pad_multiple)

    def _packed(order):
        r = np.zeros(nnz_pad, np.int32)
        c = np.zeros(nnz_pad, np.int32)
        a = np.zeros(nnz_pad, np.float64)
        d = np.zeros(nnz_pad, np.float64)
        r[:nnz] = rows[order]
        c[:nnz] = cols[order]
        a[:nnz] = np.asarray(ad_vals)[order]
        d[:nnz] = np.asarray(dp_vals)[order]
        return r, c, a, d

    row_order = np.lexsort((cols, rows))
    col_order = np.lexsort((rows, cols))
    rr, cr, ar, dr = _packed(row_order)
    rc, cc, ac, dc = _packed(col_order)

    # segment boundaries over the REAL (unpadded) prefix; padding
    # entries carry zero values so they never affect the sums
    row_ptr = np.searchsorted(rows[row_order], np.arange(n_var + 1))
    col_ptr = np.searchsorted(cols[col_order], np.arange(n_cell + 1))

    if with_ptr is None:
        with_ptr = os.environ.get("VIREO_COO_EXACT", "0") != "1"
    return SparseCounts(
        rows_r=host_put(rr), cols_r=host_put(cr),
        ad_r=host_put(ar, dtype), dp_r=host_put(dr, dtype),
        rows_c=host_put(rc), cols_c=host_put(cc),
        ad_c=host_put(ac, dtype), dp_c=host_put(dc, dtype),
        shape=(int(n_var), int(n_cell)), nnz=int(nnz),
        row_ptr=jnp.asarray(row_ptr, jnp.int32) if with_ptr else None,
        col_ptr=jnp.asarray(col_ptr, jnp.int32) if with_ptr else None,
    )


def _triplet_device_args(rows, cols, ad_v, dp_v, val_dtype, n_var=None):
    """Cast host triplets to transfer-efficient dtypes before moving
    them to device (int8 values are 30 MB instead of 240 MB at 30M nnz;
    the AD/DP pair nibble-packs further into ONE byte per entry, see
    `_encode_vals_nibble`). nnz is padded to the next power of two with
    zero-value entries at (0, 0) — scatter-add no-ops — so the scatter
    program's shape (and its persistent compile-cache entry) is reused
    across datasets instead of recompiling per exact nnz.

    Returns (rows_or_ptr, cols, vals, rows_from_ptr): when the host
    triplets are row-major sorted (the canonical union order) the
    first element is the (n_var + 1,) ROW POINTER instead of the
    per-entry row ids — 0.1 MB instead of 120 MB at 30M nnz — and the
    device scatter reconstructs rows by searchsorted. Requires
    `n_var`. `vals` is a 2-tuple (ad, dp) of device arrays or the
    4-tuple nibble encoding; `_decode_vals` (device) unpacks either.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int32)
    ad_v = np.asarray(ad_v)
    dp_v = np.asarray(dp_v)
    n = rows.shape[0]
    use_ptr = (n_var is not None and
               (n == 0 or np.all(np.diff(rows) >= 0)))
    target = max(4096, 1 << int(np.ceil(np.log2(max(n, 1)))))
    if target > n:
        pad = (0, target - n)
        if not use_ptr:
            rows = np.pad(rows, pad)
        cols = np.pad(cols, pad)
        ad_v = np.pad(ad_v, pad)
        dp_v = np.pad(dp_v, pad)
    if use_ptr:
        # padded entries (index >= nnz) search past ptr[-1] -> row
        # n_var, an out-of-bounds scatter index that jax drops; their
        # values are zero anyway
        ptr = np.searchsorted(rows, np.arange(n_var + 1)).astype(np.int32)
        first = jnp.asarray(ptr)
        cols_dev = _encode_cols_delta(cols)
    else:
        first = host_put(rows.astype(np.int32))
        cols_dev = host_put(cols)
    if jnp.dtype(val_dtype) == jnp.int8:
        vals = _encode_vals_nibble(ad_v, dp_v)
    else:
        vals = (host_put(ad_v, val_dtype),
                host_put(dp_v, val_dtype))
    return first, cols_dev, vals, use_ptr


def _pad_pow2_idempotent(pos, *value_lists, min_size=1024,
                         empty_values=None):
    """Pad exception lists to a power of two with REPEATS of the first
    entry (idempotent scatter-set), keeping device program shapes
    cacheable across datasets. An EMPTY list pads with position 0 and
    `empty_values` — which must be the TRUE values at position 0 so
    the redundant set is a no-op (zeros would clobber the entry)."""
    n = len(pos)
    target = max(min_size, 1 << int(np.ceil(np.log2(max(n, 1)))))
    if n == 0:
        pos = np.zeros(target, pos.dtype)
        value_lists = [np.full(target, e, v.dtype)
                       for v, e in zip(value_lists, empty_values)]
    elif target > n:
        reps = target - n
        pos = np.concatenate([pos, np.full(reps, pos[0], pos.dtype)])
        value_lists = [np.concatenate([v, np.full(reps, v[0], v.dtype)])
                       for v in value_lists]
    else:
        value_lists = list(value_lists)
    return (pos,) + tuple(value_lists)


def _encode_vals_nibble(ad, dp):
    """Pack the AD/DP value pair for transfer: ONE uint8 per entry
    (ad in the low nibble, dp in the high) plus an int32+int8+int8
    exception list for entries where either count exceeds 15 — scRNA
    UMI counts are predominantly single digits, so this halves the
    dominant 2 x int8 value payload of the placement transfer (~60 ->
    ~30 MB at 30M nnz). Falls back to the plain int8
    pair when exceptions would eat the saving. Values must already be
    <= 127 (the int8 transfer contract; callers clip)."""
    ad = np.asarray(ad)
    dp = np.asarray(dp)
    n = len(ad)
    if n == 0:
        return (jnp.asarray(ad, jnp.int8), jnp.asarray(dp, jnp.int8))
    small = (ad <= 15) & (dp <= 15)
    n_exc = int((~small).sum())
    # breakeven: each exception costs 6 B vs the 1 B/entry saved
    if n_exc >= n // 8:
        return (host_put(ad, jnp.int8), host_put(dp, jnp.int8))
    packed = np.where(
        small,
        (ad.astype(np.int64) | (dp.astype(np.int64) << 4)), 0
    ).astype(np.uint8)
    exc_pos = np.flatnonzero(~small).astype(np.int32)
    exc_ad = ad[~small].astype(np.int8)
    exc_dp = dp[~small].astype(np.int8)
    exc_pos, exc_ad, exc_dp = _pad_pow2_idempotent(
        exc_pos, exc_ad, exc_dp,
        empty_values=(np.int8(ad[0]), np.int8(dp[0])))
    return (host_put(packed), host_put(exc_pos),
            host_put(exc_ad), host_put(exc_dp))


def _decode_vals(vals):
    """Inverse of the `_triplet_device_args` value encoding (device):
    plain (ad, dp) pairs pass through; the nibble form unpacks and
    patches the exception entries."""
    if len(vals) == 2:
        return vals
    packed, exc_pos, exc_ad, exc_dp = vals
    ad = (packed & np.uint8(15)).astype(jnp.int8).at[exc_pos].set(exc_ad)
    dp = (packed >> np.uint8(4)).astype(jnp.int8).at[exc_pos].set(exc_dp)
    return ad, dp


def _native_encode_probe(AD, DP):
    """First pass of the fused native placement encoder: canonical CSC
    views plus union stats (nnz, n_val_exc, vmax) — the ladder keys
    its rung decision on vmax without any numpy union pass. None when
    the native library or scipy-sparse inputs are unavailable."""
    import ctypes
    import scipy.sparse as sp
    from ..io._native import lib as native_lib
    nat = native_lib()
    if nat is None or not (sp.issparse(AD) and sp.issparse(DP)):
        return None
    A = AD.tocsc()
    D = DP.tocsc()
    if A.shape != D.shape:
        return None
    mats = []
    for M in (A, D):
        if not M.has_canonical_format:
            # tocsc() returns the SAME object for CSC inputs:
            # canonicalize a copy, never the caller's matrix
            M = M.copy()
            M.sum_duplicates()
            M.sort_indices()
        mats.append(M)
    A, D = mats
    args = {}
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    for tag, M in (("a", A), ("d", D)):
        args[tag + "_indptr"] = np.ascontiguousarray(M.indptr, np.int64)
        args[tag + "_indices"] = np.ascontiguousarray(M.indices, np.int32)
        args[tag + "_data"] = np.ascontiguousarray(M.data, np.float64)
    stats = np.zeros(4, np.int64)
    rc = nat.encode_counts_stats(
        int(A.shape[1]),
        args["a_indptr"].ctypes.data_as(i64p),
        args["a_indices"].ctypes.data_as(i32p),
        args["a_data"].ctypes.data_as(f64p),
        args["d_indptr"].ctypes.data_as(i64p),
        args["d_indices"].ctypes.data_as(i32p),
        args["d_data"].ctypes.data_as(f64p),
        stats.ctypes.data_as(i64p))
    if rc < 0 or rc != stats[0] or stats[0] == 0:
        return None
    args["shape"] = tuple(int(s) for s in A.shape)
    args["nnz"] = int(stats[0])
    args["n_val_exc"] = int(stats[1])
    args["vmax"] = float(stats[2])
    args["n_over"] = int(stats[3])
    args["nat"] = nat
    return args


def _native_overflow_triplets(probe):
    """Union entries whose true value exceeds the int8 cap, with TRUE
    values — the hybrid residual's input (the count comes from the
    stats pass). None on native divergence."""
    import ctypes
    nat = probe["nat"]
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def p(x, t):
        return x.ctypes.data_as(t)

    n = probe["n_over"]
    rows = np.empty(n, np.int32)
    cols = np.empty(n, np.int32)
    at = np.empty(n, np.float64)
    dt = np.empty(n, np.float64)
    got = nat.collect_overflow_csc(
        probe["shape"][1],
        p(probe["a_indptr"], i64p), p(probe["a_indices"], i32p),
        p(probe["a_data"], f64p),
        p(probe["d_indptr"], i64p), p(probe["d_indices"], i32p),
        p(probe["d_data"], f64p),
        p(rows, i32p), p(cols, i32p), p(at, f64p), p(dt, f64p), n)
    if got != n:
        return None
    return rows, cols, at, dt


def _hybrid_from_native(probe, sharding=None):
    """int8-hybrid layout (clipped dense base + overflow residual)
    built from the fused native encoder: the base comes from the
    clipped transfer encoding; the residual and binomial correction
    are delegated to `_hybrid_from_triplets` over the collected
    true-value overflow entries. Layout arrays equal the numpy path's
    exactly; the binomial correction agrees to f64 roundoff (the
    overflow entries are summed in collection order, which differs
    between the two paths). None when the encoder declines."""
    args = _native_device_args(probe)
    if args is None:
        return None
    over = _native_overflow_triplets(probe)
    if over is None:
        return None
    first, cols_dev, vals_dev, use_ptr = args
    shape = probe["shape"]
    base = _scatter_dense(first, cols_dev, vals_dev, use_ptr, shape,
                          jnp.int8, sharding=sharding)
    rows, cols, at, dt = over
    # every passed triplet is an overflow entry, so the shared tail
    # masks nothing; warn_total keeps the residual-size warning
    # denominated in the FULL union nnz
    return _hybrid_from_triplets(rows, cols, at, dt, shape, 127,
                                 "int8", sharding=sharding, base=base,
                                 warn_total=probe["nnz"])


def _native_device_args(probe):
    """Second/third passes of the fused native encoder: device args
    (row_ptr, delta-encoded cols, nibble-packed vals) bit-matching
    `_triplet_device_args`' int8 encoding. None when the encoding
    would fall back (value exceptions >= 1/8 of entries) — the caller
    takes the numpy path instead."""
    import ctypes
    nat = probe["nat"]
    n_var, n_cell = probe["shape"]
    nnz = probe["nnz"]
    n_val_exc = probe["n_val_exc"]
    if n_val_exc >= nnz // 8:      # mirror _encode_vals_nibble
        return None
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p(x, t):
        return x.ctypes.data_as(t)

    # pad straight to the power-of-two transfer size (zeros = no-op
    # scatter entries at (n_var, 0), exactly the numpy padding)
    target = max(4096, 1 << int(np.ceil(np.log2(nnz))))
    row_ptr = np.empty(n_var + 1, np.int32)
    cols = np.zeros(target, np.int32)
    vals = np.zeros(target, np.uint8)
    vexc_pos = np.empty(n_val_exc, np.int32)
    vexc_ad = np.empty(n_val_exc, np.int8)
    vexc_dp = np.empty(n_val_exc, np.int8)
    got = nat.encode_counts_fill(
        n_var, n_cell,
        p(probe["a_indptr"], i64p), p(probe["a_indices"], i32p),
        p(probe["a_data"], f64p),
        p(probe["d_indptr"], i64p), p(probe["d_indices"], i32p),
        p(probe["d_data"], f64p),
        nnz, n_val_exc,
        p(row_ptr, i32p), p(cols, i32p), p(vals, u8p),
        p(vexc_pos, i32p), p(vexc_ad, i8p), p(vexc_dp, i8p))
    if got != nnz:
        return None

    vexc_pos, vexc_ad, vexc_dp = _pad_pow2_idempotent(
        vexc_pos, vexc_ad, vexc_dp,
        empty_values=(np.int8(vals[0] & 15), np.int8(vals[0] >> 4)))

    # column deltas over the PADDED array (the trailing zero columns
    # produce one negative-delta exception at position nnz, exactly as
    # the numpy encoder sees after np.pad)
    n_cexc = int(nat.delta_encode_cols(p(cols, i32p), target, None,
                                       None, None, 0))
    if n_cexc >= 0.25 * target:     # mirror _encode_cols_delta
        cols_dev = host_put(cols)
    else:
        deltas = np.empty(target, np.uint8)
        cexc_pos = np.empty(n_cexc, np.int32)
        cexc_val = np.empty(n_cexc, np.int32)
        # capacity EXACTLY n_cexc: if the two passes ever diverged the
        # C side bound-checks (returns -1) before writing past the
        # exact-size buffers
        got = nat.delta_encode_cols(p(cols, i32p), target,
                                    p(deltas, u8p), p(cexc_pos, i32p),
                                    p(cexc_val, i32p), n_cexc)
        if got != n_cexc:
            return None
        cexc_pos, cexc_val = _pad_pow2_idempotent(
            cexc_pos, cexc_val,
            empty_values=(np.int32(deltas[0]),))
        cols_dev = (host_put(deltas), host_put(cexc_pos),
                    host_put(cexc_val))

    vals_dev = (host_put(vals), host_put(vexc_pos),
                host_put(vexc_ad), host_put(vexc_dp))
    return jnp.asarray(row_ptr), cols_dev, vals_dev, True


def _encode_cols_delta(cols):
    """Delta-encode sorted-run column ids for transfer: uint8 forward
    deltas plus an int32 exception list for row-boundary jumps and
    gaps >= 256 — ~49 MB instead of 120 MB at 30M nnz. cols must already be padded; a global device
    cumsum reconstructs the ids exactly (`_decode_cols`). Falls back
    to plain int32 when exceptions would dominate."""
    cols = np.asarray(cols, np.int64)
    if len(cols) == 0:
        return jnp.asarray(cols.astype(np.int32))
    d = np.diff(cols, prepend=np.int64(0))
    small = (d >= 0) & (d < 256)
    n_exc = int((~small).sum())
    if n_exc >= 0.25 * len(cols):
        return host_put(cols.astype(np.int32))
    deltas = np.where(small, d, 0).astype(np.uint8)
    exc_pos = np.flatnonzero(~small).astype(np.int32)
    exc_val = d[~small].astype(np.int32)
    # pad the exception list to a power of two with REPEATS of the
    # first entry (idempotent scatter-set), keeping the decode
    # program's shape cacheable across datasets
    target = max(1024, 1 << int(np.ceil(np.log2(max(n_exc, 1)))))
    if n_exc == 0:
        exc_pos = np.zeros(target, np.int32)
        exc_val = np.full(target, int(d[0]), np.int32)
    elif target > n_exc:
        reps = target - n_exc
        exc_pos = np.concatenate([exc_pos,
                                  np.full(reps, exc_pos[0], np.int32)])
        exc_val = np.concatenate([exc_val,
                                  np.full(reps, exc_val[0], np.int32)])
    return (host_put(deltas), host_put(exc_pos),
            host_put(exc_val))


def _decode_cols(cols):
    """Inverse of `_encode_cols_delta` (device): widen, patch the
    exceptions, global cumsum. Plain arrays pass through."""
    if isinstance(cols, tuple):
        deltas, exc_pos, exc_val = cols
        d32 = deltas.astype(jnp.int32).at[exc_pos].set(exc_val)
        return jnp.cumsum(d32)
    return cols


def _chunk_rows(first, use_ptr, lo, m):
    """Row ids for entries [lo, lo+m): a slice of the shipped row array,
    or a searchsorted reconstruction from the row pointer."""
    if not use_ptr:
        return jax.lax.dynamic_slice_in_dim(first, lo, m)
    idx = lo + jnp.arange(m, dtype=jnp.int32)
    return (jnp.searchsorted(first, idx, side="right") - 1).astype(
        jnp.int32)


def _densify_triplets(rows, cols, ad_v, dp_v, shape, dtype,
                      sharding=None):
    """Chunked device scatter of COO triplets into dense (V, C) arrays.

    The scatter runs in nnz chunks (2^19 entries by default) so the
    index and value temporaries stay small while the dense
    accumulators are carried through the loop. int8 targets clip
    host-visible values at 127 (saturate, never wrap).
    """
    shape = tuple(int(s) for s in shape)
    # move values in the smallest exact transfer dtype
    use_ptr = False
    if not isinstance(ad_v, jax.Array):
        if dtype == jnp.int8:
            ad_v = np.minimum(np.asarray(ad_v), 127)
            dp_v = np.minimum(np.asarray(dp_v), 127)
            transfer = jnp.int8
        else:
            transfer = jnp.float32 if dtype in (jnp.bfloat16,
                                                jnp.float32) \
                else jnp.float64
        rows, cols, vals, use_ptr = _triplet_device_args(
            rows, cols, ad_v, dp_v,
            jnp.int8 if dtype == jnp.int8 else transfer,
            n_var=shape[0])
    else:
        vals = (ad_v, dp_v)
    return _scatter_dense(rows, cols, vals, use_ptr, shape, dtype,
                          sharding=sharding)


def _scatter_dense(rows, cols, vals, use_ptr, shape, dtype,
                   sharding=None):
    """Run the chunked dense scatter over pre-built device args (see
    `_triplet_device_args` for the encodings of `cols` and `vals`)."""
    block = _scatter_block()

    def scatter(vals, rows, cols):
        ad_v, dp_v = _decode_vals(vals)
        if dtype == jnp.int8 and ad_v.dtype != jnp.int8:
            ad_v = jnp.clip(ad_v, 0, 127)
            dp_v = jnp.clip(dp_v, 0, 127)
        cols = _decode_cols(cols)
        n = ad_v.shape[0]
        blk = min(block, n)
        n_full = n // blk

        def add_chunk(lo, m, bufs):
            ad_b, dp_b = bufs
            r = _chunk_rows(rows, use_ptr, lo, m)
            c = jax.lax.dynamic_slice_in_dim(cols, lo, m)
            a = jax.lax.dynamic_slice_in_dim(ad_v, lo, m)
            d = jax.lax.dynamic_slice_in_dim(dp_v, lo, m)
            return (ad_b.at[r, c].add(a.astype(dtype)),
                    dp_b.at[r, c].add(d.astype(dtype)))

        bufs = (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))
        if n_full:
            bufs = jax.lax.fori_loop(
                0, n_full, lambda i, b: add_chunk(i * blk, blk, b),
                bufs)
        rem = n - n_full * blk
        if rem:
            bufs = add_chunk(n_full * blk, rem, bufs)
        return bufs

    if sharding is not None:
        try:
            sharding.shard_shape(shape)
        except Exception:
            # unevenly sharded dim (out_shardings requires exact
            # divisibility, and device_put enforces the same): drop
            # the non-dividing axes from the spec and scatter into the
            # reduced sharding — still split along the remaining axes.
            # The previous fallback built the FULL dense pair
            # unsharded, which is exactly the matrix a capacity mesh
            # exists because one chip cannot hold (advisor round-4).
            import warnings
            reduced = _divisible_sharding(shape, sharding)
            warnings.warn(
                "[vireo] count shape %s is not divisible by the "
                "requested sharding %s; densifying with the reduced "
                "spec %s (pad the uneven axis to a multiple of its "
                "mesh extent for the full split)"
                % (shape, sharding.spec, reduced.spec))
            sharding = reduced
        scatter = jax.jit(scatter, out_shardings=(sharding, sharding))
    else:
        scatter = jax.jit(scatter)
    ad, dp = scatter(vals, rows, cols)
    return DenseCounts(ad, dp)


def _pack_triplets(rows, cols, ad_v, dp_v, shape, clip=False):
    """Chunked device scatter of COO triplets into the 4-bit
    nibble-packed layout (int8 adds wrap mod 256, bit-exact for
    disjoint nibbles; see _densify_triplets for the chunking)."""
    from .packed import PackedCounts, PACK_MAX
    V, C = (int(s) for s in shape)
    Cp2 = -(-C // 2)
    use_ptr = False
    if not isinstance(ad_v, jax.Array):
        if clip:
            ad_v = np.minimum(np.asarray(ad_v), PACK_MAX)
            dp_v = np.minimum(np.asarray(dp_v), PACK_MAX)
        rows, cols, vals, use_ptr = _triplet_device_args(
            rows, cols, ad_v, dp_v, jnp.int8, n_var=V)
        # clipped values all fit a nibble: the transfer is always the
        # packed single-byte form with an empty exception list
        ad_v, dp_v = jax.jit(_decode_vals)(vals)
        clip = False
    block = _scatter_block()

    @partial(jax.jit, static_argnames=("from_ptr",))
    def scatter(vals, rows, cols, from_ptr=False):
        v = vals.astype(jnp.int32)
        if clip:
            v = jnp.minimum(v, PACK_MAX)
        cols = _decode_cols(cols)
        shift = (cols & 1) * 4
        b = jnp.where(v << shift > 127, (v << shift) - 256,
                      v << shift).astype(jnp.int8)
        n = vals.shape[0]
        blk = min(block, n)
        n_full = n // blk

        def add_chunk(lo, m, buf):
            r = _chunk_rows(rows, from_ptr, lo, m)
            c = jax.lax.dynamic_slice_in_dim(cols, lo, m)
            x = jax.lax.dynamic_slice_in_dim(b, lo, m)
            return buf.at[r, c // 2].add(x)

        buf = jnp.zeros((V, Cp2), jnp.int8)
        if n_full:
            buf = jax.lax.fori_loop(
                0, n_full, lambda i, y: add_chunk(i * blk, blk, y),
                buf)
        rem = n - n_full * blk
        if rem:
            buf = add_chunk(n_full * blk, rem, buf)
        return buf

    rows = jnp.asarray(np.asarray(rows), jnp.int32) \
        if not isinstance(rows, (jax.Array, tuple)) else rows
    if not isinstance(cols, tuple):
        cols = (jnp.asarray(np.asarray(cols), jnp.int32)
                if not isinstance(cols, jax.Array)
                else cols).astype(jnp.int32)
    return PackedCounts(
        ad_p=scatter(ad_v, rows, cols, from_ptr=use_ptr),
        dp_p=scatter(dp_v, rows, cols, from_ptr=use_ptr),
        shape=(V, C))


def exact_count_dtype(vmax):
    """Smallest dtype representing integer counts up to `vmax` exactly:
    int8 (1 B, <=127), bfloat16 (2 B, <=256, 8-bit mantissa), else
    float32 (4 B, <=2^24)."""
    if vmax <= 127:
        return jnp.int8
    if vmax <= 256:
        return jnp.bfloat16
    return jnp.float32


def _scipy_clip(X, cap):
    """Copy of a scipy-sparse / numpy count matrix clipped at `cap`."""
    if hasattr(X, "data"):
        Y = X.copy()
        Y.data = np.minimum(Y.data, cap)
        return Y
    return np.minimum(np.asarray(X), cap)


def device_dense_budget():
    """Device bytes available for the two dense count matrices.

    0.55 x the default device's reported `bytes_limit` (the rest is
    headroom for posteriors and fusion temporaries; on a GPU the limit
    is the share JAX reserves at start-up, 75% of the card unless
    XLA_PYTHON_CLIENT_MEM_FRACTION says otherwise).
    VIREO_DENSE_BUDGET_GB overrides. The CPU platform reports no limit
    and gets 16 GiB; any other device without one is an error, not a
    guess.
    """
    env = os.environ.get("VIREO_DENSE_BUDGET_GB")
    if env:
        return float(env) * 2**30
    dev = jax.devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if limit:
        return 0.55 * limit
    if dev.platform == "cpu":
        return 16 * 2**30
    raise RuntimeError(
        "%s device %r reports no memory limit; set VIREO_DENSE_BUDGET_GB"
        % (dev.platform, dev.device_kind))


def _shard_factor(sharding):
    """Number of ways a NamedSharding splits the count matrices (the
    product of the mesh extents its spec actually uses): the dense
    ladder's memory budget aggregates across those devices."""
    if sharding is None:
        return 1
    try:
        f = 1
        for ax in sharding.spec:
            if ax is not None:
                f *= int(sharding.mesh.shape[ax])
        return max(int(f), 1)
    except Exception:
        return 1


def _divisible_sharding(shape, sharding):
    """`sharding` with every spec axis whose mesh extent does not
    divide the corresponding dim dropped (replicated). Always valid
    for `out_shardings`; equals the input when all dims divide."""
    from jax.sharding import NamedSharding, PartitionSpec
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    kept = tuple(
        ax if ax is not None and s % int(sharding.mesh.shape[ax]) == 0
        else None
        for s, ax in zip(shape, spec))
    return NamedSharding(sharding.mesh, PartitionSpec(*kept))


def _cell_axis_of(sharding):
    """The CELL axis of a count sharding — the LAST non-None spec entry
    (count_spec is P(vars?, cells)). The packed layout shards cells
    ONLY, so this (not the first non-None axis) is what
    pack_scipy_sharded must split along."""
    axes = [a for a in sharding.spec if a is not None]
    return axes[-1] if axes else None


def _packed_shard_factor(sharding):
    """Number of ways the PACKED layout splits the count bytes: only
    the cell axis — MeshPackedCounts is 1-D, so on a 2-D vars x cells
    mesh the packed budget must NOT aggregate over the vars extent
    (sizing with the full device count risks an ~Nv-fold per-device
    overshoot at the capacity boundary)."""
    if sharding is None:
        return 1
    try:
        ax = _cell_axis_of(sharding)
        return max(int(sharding.mesh.shape[ax]), 1) if ax else 1
    except Exception:
        return 1


def counts_from_scipy(AD, DP, dtype=jnp.float32, max_dense_elems=64_000_000,
                      dense_budget=None, sharding=None, verbose=False):
    """Pick the device representation for a scipy/numpy AD-DP pair.

    Mirrors (inverted) the reference's dense->sparse auto-conversion
    heuristic (vireo_wrap.py:29-34): dense is preferred whenever it
    fits (whether a sparse contraction beats it at ~1% site density on
    the GPU is not yet measured):

    - small matrices (<= max_dense_elems) stay dense in the caller's
      `dtype` (float32 default: full-precision trajectories, the
      golden-parity configuration);
    - larger matrices densify ON DEVICE via COO scatter into the
      smallest dtype that holds every count exactly (int8 <= 127,
      bf16 <= 256, f32 — see `exact_count_dtype`), sharded per
      `sharding` if given, as long as both matrices fit `dense_budget`;
    - only when dense genuinely cannot fit does the padded-COO
      segment-sum backend take over.
    """
    n_elems = int(AD.shape[0]) * int(AD.shape[1])
    if n_elems <= max_dense_elems:
        c = dense_counts(AD, DP, dtype=dtype)
        if sharding is not None:
            c = DenseCounts(jax.device_put(c.ad, sharding),
                            jax.device_put(c.dp, sharding))
        return c

    # ONE host alignment pass. The fused native encoder covers the
    # production path end to end (union stats -> rung decision ->
    # transfer encoding) in three flat C passes; otherwise a numpy
    # union materializes triplets and each rung builds its own layout
    # (the dual-sorted COO with segment pointers — ~1 GB of device
    # arrays and two 30M lexsorts — is only constructed when the
    # pure-COO fallback is actually taken).
    probe = _native_encode_probe(AD, DP)
    rows = cols = ad_v = dp_v = None
    if probe is not None:
        vmax = probe["vmax"]
    else:
        rows, cols, ad_v, dp_v = _host_union_triplets(AD, DP)
        vmax = float(max(ad_v.max() if len(ad_v) else 0.0,
                         dp_v.max() if len(dp_v) else 0.0))
    shape = tuple(int(s) for s in AD.shape)
    dense_dtype = exact_count_dtype(vmax)
    if dense_budget is not None:
        budget = dense_budget          # explicit budgets are TOTALS
        packed_budget = dense_budget
    else:
        # a mesh sharding splits the dense layouts across devices: the
        # ladder sizes against the AGGREGATE memory of the devices it
        # spans (this is what makes n-card pools n times larger per
        # rung).
        # The packed rungs shard along the CELL axis only, so their
        # budget aggregates over that extent alone.
        budget = device_dense_budget() * _shard_factor(sharding)
        packed_budget = device_dense_budget() * _packed_shard_factor(
            sharding)
    need = 2 * n_elems * jnp.dtype(dense_dtype).itemsize
    if need <= budget:
        if verbose:
            print("[vireo] %dx%d counts (max %.0f) densified on device "
                  "as %s (%.1f GiB)" % (AD.shape[0], AD.shape[1], vmax,
                                        jnp.dtype(dense_dtype).name,
                                        need / 2**30))
        if probe is not None and dense_dtype == jnp.int8:
            args = _native_device_args(probe)
            if args is not None:
                first, cols_dev, vals_dev, use_ptr = args
                return _scatter_dense(first, cols_dev, vals_dev,
                                      use_ptr, shape, jnp.int8,
                                      sharding=sharding)
        if rows is None:
            rows, cols, ad_v, dp_v = _host_union_triplets(AD, DP)
        return _densify_triplets(rows, cols, ad_v, dp_v, shape,
                                 dense_dtype, sharding=sharding)
    no_hybrid = os.environ.get("VIREO_NO_HYBRID", "0") == "1"
    # hybrid rung: int8 base clipped at 127 + COO residual of the rare
    # overflow deltas — the dense rung's contraction at ANY count
    # magnitude. This covers the regime the exact ladder above cannot
    # (vmax > 127 with bf16/f32 exceeding the budget).
    if vmax > 127 and 2 * n_elems <= budget and not no_hybrid:
        if verbose:
            print("[vireo] %dx%d counts (max %.0f) split into int8 base "
                  "+ overflow residual (%.1f GiB dense)"
                  % (AD.shape[0], AD.shape[1], vmax, 2 * n_elems / 2**30))
        if probe is not None:
            h = _hybrid_from_native(probe, sharding=sharding)
            if h is not None:
                return h
        if rows is None:
            rows, cols, ad_v, dp_v = _host_union_triplets(AD, DP)
        return _hybrid_from_triplets(rows, cols, ad_v, dp_v, shape,
                                     127, "int8", sharding=sharding)
    if rows is None:   # remaining rungs build from numpy triplets
        rows, cols, ad_v, dp_v = _host_union_triplets(AD, DP)
    # capacity rung: 4-bit nibble packing halves the dense footprint
    # whenever every count fits a nibble (<= 15), keeping matrices
    # dense below the COO fallback. On a mesh the packed bytes are
    # sharded along the cell axis (MeshPackedCounts) so multi-card
    # pools get the 2x capacity too.
    from .packed import PACK_MAX
    packed_ok = os.environ.get("VIREO_NO_PACKED", "0") != "1"
    if vmax <= PACK_MAX and n_elems <= packed_budget and packed_ok:
        if verbose:
            print("[vireo] %dx%d counts (max %.0f) packed 2-per-byte on "
                  "device (%.1f GiB)" % (AD.shape[0], AD.shape[1], vmax,
                                         n_elems / 2**30))
        if sharding is not None and sharding.mesh.devices.size > 1:
            from .packed import pack_scipy_sharded
            return pack_scipy_sharded(AD, DP, sharding.mesh,
                                      axis=_cell_axis_of(sharding))
        return _pack_triplets(rows, cols, ad_v, dp_v, shape)
    # packed hybrid rung: nibble base clipped at 15 + overflow residual
    # — the half-footprint capacity rung without the count-magnitude
    # restriction.
    if vmax > PACK_MAX and n_elems <= packed_budget and packed_ok \
            and not no_hybrid:
        if verbose:
            print("[vireo] %dx%d counts (max %.0f) split into packed "
                  "nibble base + overflow residual (%.1f GiB)"
                  % (AD.shape[0], AD.shape[1], vmax, n_elems / 2**30))
        base = None
        if sharding is not None and sharding.mesh.devices.size > 1:
            from .packed import pack_scipy_sharded
            base = pack_scipy_sharded(_scipy_clip(AD, PACK_MAX),
                                      _scipy_clip(DP, PACK_MAX),
                                      sharding.mesh,
                                      axis=_cell_axis_of(sharding))
        return _hybrid_from_triplets(rows, cols, ad_v, dp_v, shape,
                                     PACK_MAX, "packed",
                                     sharding=sharding, base=base)
    if verbose:
        print("[vireo] %dx%d counts too large for a dense layout "
              "(%.1f GiB > budget %.1f GiB); using COO segment-sum"
              % (AD.shape[0], AD.shape[1], need / 2**30, budget / 2**30))
    return _sparse_from_triplets(rows, cols, ad_v, dp_v, shape,
                                 dtype=dtype)
