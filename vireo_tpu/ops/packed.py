"""4-bit nibble-packed dense counts: the capacity rung of the ladder.

ScRNA allele counts are tiny integers; whenever every AD/DP value is
<= 15, two cells fit in one byte. The packed layout halves the device
footprint of the int8 dense layout, doubling the pool one card can
hold dense. The ladder (`counts.counts_from_scipy`) takes it only when
int8 dense does not fit the memory budget.

Layout: `ad_p`/`dp_p` are (n_var, ceil(n_cell / 2)) int8 where byte
[v, j] holds the counts of cells (2j, 2j+1) in its (low, high) nibble;
an odd cell count leaves a zero high nibble in the last column.

Contractions are plain XLA. Each block of variant rows is unpacked
(`p & 0xF`, `(p >> 4) & 0xF`) and contracted against the even/odd cell
halves of the weights with the dense rung's product (`counts.fold_rows`,
`counts.count_dot`), so the unpacked temporary is bounded by one row
block whatever the pool size.

Reference data path being replaced: scipy CSC spMMs in
vireoSNP/utils/vireo_model.py:165-219.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .counts import DenseCounts, fold_rows, count_dot
from .math import log_binom_coeff

__all__ = ["PackedCounts", "MeshPackedCounts", "pack_dense",
           "pack_scipy_sharded", "PACK_MAX"]

PACK_MAX = 15  # largest count a nibble holds exactly


def _unpack(p):
    """Packed bytes -> (lo, hi) nibble planes in p's dtype (an
    arithmetic shift sign-extends; the mask recovers the unsigned high
    nibble)."""
    return p & 0xF, (p >> 4) & 0xF


def _interleave(even, odd):
    """(n, ...) even-cell and odd-cell planes -> (2n, ...) cell order."""
    return jnp.stack([even, odd], axis=1).reshape(
        (2 * even.shape[0],) + even.shape[1:])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedCounts:
    """Nibble-packed dense AD/DP counts (two cells per byte)."""
    ad_p: jax.Array                 # (n_var, ceil(n_cell / 2)) int8
    dp_p: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_var(self):
        return self.shape[0]

    @property
    def n_cell(self):
        return self.shape[1]

    def _fold(self, fn, init, *row_args):
        return fold_rows(fn, init, self.ad_p, self.dp_p, *row_args)

    def suff_stats(self, W):
        """(AD @ W, DP @ W) for W (n_cell, K) -> two (n_var, K)."""
        Cp2 = self.ad_p.shape[1]
        W = jnp.pad(W, ((0, 2 * Cp2 - self.n_cell), (0, 0)))
        we, wo = W[0::2], W[1::2]

        def fn(lo, a, d, acc):
            a_lo, a_hi = _unpack(a)
            d_lo, d_hi = _unpack(d)
            put = jax.lax.dynamic_update_slice_in_dim
            return (put(acc[0], count_dot(a_lo, we) + count_dot(a_hi, wo),
                        lo, 0),
                    put(acc[1], count_dot(d_lo, we) + count_dot(d_hi, wo),
                        lo, 0))

        z = jnp.zeros((self.n_var, W.shape[1]), W.dtype)
        return self._fold(fn, (z, z))

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd for (n_var, K) weights -> (n_cell, K)."""
        def fn(lo, a, d, wa, wd, acc):
            a_lo, a_hi = _unpack(a)
            d_lo, d_hi = _unpack(d)
            return (acc[0] + count_dot(a_lo.T, wa) + count_dot(d_lo.T, wd),
                    acc[1] + count_dot(a_hi.T, wa) + count_dot(d_hi.T, wd))

        z = jnp.zeros((self.ad_p.shape[1], Wa.shape[1]), Wa.dtype)
        even, odd = self._fold(fn, (z, z), Wa, Wd)
        return _interleave(even, odd)[:self.n_cell]

    # ---- reductions / reshapes (cold paths) -------------------------

    def binom_coeff_sum(self):
        """Sum of log C(DP, AD); padding nibbles hold (0, 0) -> 0 terms."""
        return _binom_coeff_sum(self)

    def _binom_coeff_sum_impl(self):
        def fn(lo, a, d, acc):
            a_lo, a_hi = _unpack(a.astype(jnp.int32))
            d_lo, d_hi = _unpack(d.astype(jnp.int32))
            return (acc + jnp.sum(log_binom_coeff(d_lo, a_lo))
                    + jnp.sum(log_binom_coeff(d_hi, a_hi)))
        # accumulate in log_binom_coeff's result dtype (f64 under x64),
        # matching the dense path
        acc_dtype = jax.eval_shape(
            log_binom_coeff,
            jax.ShapeDtypeStruct((1,), jnp.int32),
            jax.ShapeDtypeStruct((1,), jnp.int32)).dtype
        return self._fold(fn, jnp.zeros((), acc_dtype))

    def row_sums(self):
        return _row_sums(self)

    def _row_sums_impl(self):
        """(AD.sum(axis=1), DP.sum(axis=1))."""
        def fn(lo, a, d, acc):
            a_lo, a_hi = _unpack(a.astype(jnp.int32))
            d_lo, d_hi = _unpack(d.astype(jnp.int32))
            put = jax.lax.dynamic_update_slice_in_dim
            return (put(acc[0], jnp.sum(a_lo + a_hi, axis=1).astype(
                        jnp.float32), lo, 0),
                    put(acc[1], jnp.sum(d_lo + d_hi, axis=1).astype(
                        jnp.float32), lo, 0))

        z = jnp.zeros((self.n_var,), jnp.float32)
        return self._fold(fn, (z, z))

    def n_vars_per_cell(self):
        return _n_vars_per_cell(self)

    def _n_vars_per_cell_impl(self):
        def fn(lo, a, d, acc):
            # dtype= pins the bool-sum to the carry dtype (x64 would
            # otherwise promote it to int64 and break the fori_loop)
            d_lo, d_hi = _unpack(d)
            return (acc[0] + jnp.sum(d_lo > 0, axis=0, dtype=jnp.int32),
                    acc[1] + jnp.sum(d_hi > 0, axis=0, dtype=jnp.int32))

        z = jnp.zeros((self.ad_p.shape[1],), jnp.int32)
        even, odd = self._fold(fn, (z, z))
        return _interleave(even, odd)[:self.n_cell]

    def densify(self, dtype=jnp.int8):
        """Unpack to a DenseCounts (int8 by default; 2x the memory)."""
        n_cell = self.n_cell

        @jax.jit
        def unpack(p):
            lo, hi = _unpack(p)
            full = jnp.stack([lo, hi], axis=2).reshape(p.shape[0], -1)
            return full[:, :n_cell].astype(dtype)

        return DenseCounts(unpack(self.ad_p), unpack(self.dp_p))

    def var_subset(self, idx):
        idx = jnp.asarray(idx)
        return PackedCounts(ad_p=self.ad_p[idx], dp_p=self.dp_p[idx],
                            shape=(int(idx.shape[0]), self.n_cell))

    def cell_slice(self, start, stop):
        """Unpack only the byte range covering [start, stop) — a full
        densify would double the footprint the packed rung exists to
        avoid."""
        start, stop = int(start), int(stop)
        b0, b1 = start // 2, -(-stop // 2)
        off = start - 2 * b0

        @jax.jit
        def unpack(p):
            lo, hi = _unpack(p[:, b0:b1])
            full = jnp.stack([lo, hi], axis=2).reshape(p.shape[0], -1)
            return full[:, off:off + (stop - start)]

        return DenseCounts(unpack(self.ad_p), unpack(self.dp_p))


_binom_coeff_sum = jax.jit(PackedCounts._binom_coeff_sum_impl)
_row_sums = jax.jit(PackedCounts._row_sums_impl)
_n_vars_per_cell = jax.jit(PackedCounts._n_vars_per_cell_impl)


@jax.jit
def _pack_pair(x):
    """(V, C) integer counts -> (V, ceil(C / 2)) int8 nibble bytes."""
    if x.shape[1] % 2:
        x = jnp.pad(x, ((0, 0), (0, 1)))
    v = x[:, 0::2].astype(jnp.int32) | (x[:, 1::2].astype(jnp.int32) << 4)
    return jnp.where(v > 127, v - 256, v).astype(jnp.int8)


def pack_dense(ad, dp, shape=None, check_range=True):
    """Build PackedCounts from (n_var, n_cell) count arrays (device or
    host). All values must be in [0, 15]; `check_range` checks this on
    host inputs (device inputs are the caller's responsibility — the
    counts_from_scipy ladder checks the max before packing)."""
    if hasattr(ad, "ad"):  # DenseCounts
        ad, dp = ad.ad, ad.dp
    if shape is None:
        shape = tuple(int(s) for s in ad.shape)
    if check_range and isinstance(ad, np.ndarray):
        for name, x in (("AD", ad), ("DP", dp)):
            if x.min() < 0 or x.max() > PACK_MAX:
                raise ValueError("%s counts outside [0, %d]"
                                 % (name, PACK_MAX))
    return PackedCounts(ad_p=_pack_pair(jnp.asarray(ad)),
                        dp_p=_pack_pair(jnp.asarray(dp)), shape=shape)


# --------------------------------------------------------------------
# mesh-sharded packed layout: the capacity rung on multi-card pools
# --------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeshPackedCounts:
    """Nibble-packed counts sharded over a 1-D device mesh along the
    packed-cell axis.

    Each device owns a self-contained packed block of `2 * c2_local`
    consecutive cells (so global cell indexing stays contiguous and
    W/loglik padding is a plain tail pad). Every contraction shard_maps
    the single-device PackedCounts contraction over the mesh: cell-side
    outputs stay sharded, variant-side sufficient statistics are
    psum'd — the same collective pattern as the dense GSPMD path
    (parallel/mesh.py), ~n_var * K * 4 B per call.

    Extends the reference's only capacity mechanism (--cellRange manual
    chunking, vireoSNP/vireo.py:136-142) to one transparent multi-card
    object.
    """
    ad_p: jax.Array                 # (n_var, S * c2_local) int8, sharded
    dp_p: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    mesh: object = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))

    @property
    def n_var(self):
        return self.shape[0]

    @property
    def n_cell(self):
        return self.shape[1]

    @property
    def n_shards(self):
        return int(self.mesh.shape[self.axis])

    @property
    def c2_local(self):
        return self.ad_p.shape[1] // self.n_shards

    @property
    def n_cell_pad(self):
        return 2 * self.ad_p.shape[1]

    def _local(self, ad_p, dp_p):
        """Shard-local view: padding cells are real zero-count cells."""
        return PackedCounts(ad_p=ad_p, dp_p=dp_p,
                            shape=(self.n_var, 2 * ad_p.shape[1]))

    def _shard_map(self, f, in_specs, out_specs):
        return jax.shard_map(f, mesh=self.mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def _pad_cells(self, W):
        return jnp.pad(W, ((0, self.n_cell_pad - self.n_cell), (0, 0)))

    def suff_stats(self, W):
        """(AD @ W, DP @ W) with a per-call psum of the (n_var, K)
        statistics over the mesh axis."""
        from jax.sharding import PartitionSpec as P
        a = self.axis

        def f(ad_p, dp_p, Wl):
            S1, SS = self._local(ad_p, dp_p).suff_stats(Wl)
            return jax.lax.psum((S1, SS), a)

        return self._shard_map(
            f, (P(None, a), P(None, a), P(a, None)), (P(), P()))(
            self.ad_p, self.dp_p, self._pad_cells(W))

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd; cell-sharded output, no collective."""
        from jax.sharding import PartitionSpec as P
        a = self.axis

        def f(ad_p, dp_p, wa, wd):
            return self._local(ad_p, dp_p).cell_loglik(wa, wd)

        out = self._shard_map(
            f, (P(None, a), P(None, a), P(), P()), P(a, None))(
            self.ad_p, self.dp_p, Wa, Wd)
        return out[:self.n_cell]

    def binom_coeff_sum(self):
        from jax.sharding import PartitionSpec as P
        a = self.axis

        def f(ad_p, dp_p):
            return jax.lax.psum(
                self._local(ad_p, dp_p).binom_coeff_sum(), a)

        return self._shard_map(f, (P(None, a), P(None, a)), P())(
            self.ad_p, self.dp_p)

    def row_sums(self):
        from jax.sharding import PartitionSpec as P
        a = self.axis

        def f(ad_p, dp_p):
            return jax.lax.psum(self._local(ad_p, dp_p).row_sums(), a)

        return self._shard_map(f, (P(None, a), P(None, a)), (P(), P()))(
            self.ad_p, self.dp_p)

    def n_vars_per_cell(self):
        from jax.sharding import PartitionSpec as P
        a = self.axis

        def f(ad_p, dp_p):
            return self._local(ad_p, dp_p).n_vars_per_cell()

        out = self._shard_map(f, (P(None, a), P(None, a)), P(a))(
            self.ad_p, self.dp_p)
        return out[:self.n_cell]

    def var_subset(self, idx):
        """Row gather on the replicated variant axis (GSPMD keeps the
        cell sharding)."""
        idx = jnp.asarray(np.asarray(idx))
        return dataclasses.replace(
            self, ad_p=self.ad_p[idx], dp_p=self.dp_p[idx],
            shape=(int(idx.shape[0]), self.n_cell))

    def cell_slice(self, start, stop):
        """Host-side fallback (--cellRange): gather only the byte range
        covering the slice (possibly across processes), unpack on one
        device."""
        from ..utils.fetch import host_fetch
        start, stop = int(start), int(stop)
        b0, b1 = start // 2, -(-stop // 2)
        ad = host_fetch(self.ad_p[:, b0:b1])
        dp = host_fetch(self.dp_p[:, b0:b1])
        single = PackedCounts(ad_p=jnp.asarray(ad), dp_p=jnp.asarray(dp),
                              shape=(self.n_var, 2 * (b1 - b0)))
        off = start - 2 * b0
        return single.cell_slice(off, off + (stop - start))

    def densify(self, dtype=jnp.int8):
        from jax.sharding import PartitionSpec as P
        a = self.axis

        def f(ad_p, dp_p):
            d = self._local(ad_p, dp_p).densify(dtype=dtype)
            return d.ad, d.dp

        ad, dp = self._shard_map(
            f, (P(None, a), P(None, a)), (P(None, a), P(None, a)))(
            self.ad_p, self.dp_p)
        return DenseCounts(ad[:, :self.n_cell], dp[:, :self.n_cell])


def pack_scipy_sharded(AD, DP, mesh, axis=None):
    """Pack a scipy/numpy AD-DP pair into a MeshPackedCounts: cells are
    split into equal per-device ranges (an even cell count each), each
    range packed host-side, and the concatenation placed as one global
    array sharded along the packed-cell axis.

    All counts must fit a nibble (<= 15); the counts_from_scipy ladder
    checks the max first.
    """
    import scipy.sparse as sp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if axis is None:
        axis = mesh.axis_names[0]
    S = int(mesh.shape[axis])
    A = sp.csc_matrix(AD)
    D = sp.csc_matrix(DP)
    V, C = A.shape
    c2_local = -(-(-(-C // S)) // 2)           # packed columns per device
    c_local = 2 * c2_local

    def pack_range(M, lo, hi):
        sub = sp.coo_matrix(M[:, lo:hi])
        out = np.zeros((V, c2_local), np.uint8)
        vals = sub.data.astype(np.uint8) << ((sub.col & 1) * 4).astype(
            np.uint8)
        np.bitwise_or.at(out, (sub.row, sub.col // 2), vals)
        return out.view(np.int8)

    ad_blocks, dp_blocks = [], []
    for s in range(S):
        lo, hi = s * c_local, min((s + 1) * c_local, C)
        ad_blocks.append(pack_range(A, lo, hi))
        dp_blocks.append(pack_range(D, lo, hi))
    sh = NamedSharding(mesh, P(None, axis))
    ad_p = jax.device_put(jnp.asarray(np.concatenate(ad_blocks, 1)), sh)
    dp_p = jax.device_put(jnp.asarray(np.concatenate(dp_blocks, 1)), sh)
    return MeshPackedCounts(ad_p=ad_p, dp_p=dp_p, shape=(int(V), int(C)),
                            mesh=mesh, axis=axis)
