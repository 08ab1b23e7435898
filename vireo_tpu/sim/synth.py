"""Synthetic multiplexed-pool generator with ground truth.

The reference's simulator (/root/reference/simulate/synth_pool.py)
synthesizes pooled BAMs and re-genotypes them with cellSNP — an
I/O-bound host pipeline around external tools. For engine benchmarking
and accuracy validation none of that is needed: this module samples
AD/DP count matrices directly from the generative model the engine
fits (donor genotypes -> binomial allele counts), with doublet cells
mixed from donor pairs (cf. synth_pool.py:39-95 doublet pairing), and
returns the ground-truth cell->donor table.
"""

import gzip
import os

import numpy as np

__all__ = ["synth_pool_counts", "synth_pool_dense_device",
           "write_cellsnp_dir"]


def synth_pool_counts(n_var=30000, n_cell=100000, n_donor=16,
                      doublet_rate=0.0, density=0.01, mean_extra_depth=0.6,
                      theta=(0.01, 0.5, 0.99), seed=0):
    """Sample a synthetic pool.

    Returns dict with:
      AD, DP: scipy.sparse.csc_matrix (n_var, n_cell)
      donor:  (n_cell,) primary donor index
      donor2: (n_cell,) second donor for doublets, else -1
      GT:     (n_var, n_donor) true genotypes in {0,1,2}
    """
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)

    # donor genotypes: per-variant population allele frequency
    af = rng.beta(0.8, 0.8, size=n_var)
    GT = rng.binomial(2, af[:, None], size=(n_var, n_donor)).astype(np.int8)

    donor = rng.randint(0, n_donor, size=n_cell)
    donor2 = np.full(n_cell, -1, dtype=np.int64)
    n_doublet = int(n_cell * doublet_rate)
    if n_doublet > 0:
        dbl_idx = rng.choice(n_cell, size=n_doublet, replace=False)
        d2 = rng.randint(0, n_donor, size=n_doublet)
        # avoid same-donor "doublets"
        same = d2 == donor[dbl_idx]
        d2[same] = (d2[same] + 1) % n_donor
        donor2[dbl_idx] = d2

    # sparse site coverage: variant popularity ~ Gamma, cells uniform
    w = rng.gamma(1.0, 1.0, size=n_var)
    w /= w.sum()
    nnz_target = int(density * n_var * n_cell)
    rows = rng.choice(n_var, size=nnz_target, p=w)
    cols = rng.randint(0, n_cell, size=nnz_target)
    key = rows.astype(np.int64) * n_cell + cols
    key = np.unique(key)
    rows = (key // n_cell).astype(np.int32)
    cols = (key % n_cell).astype(np.int32)
    nnz = len(rows)

    dp = 1 + rng.poisson(mean_extra_depth, size=nnz)

    theta = np.asarray(theta)
    p1 = theta[GT[rows, donor[cols]]]
    is_dbl = donor2[cols] >= 0
    p2 = np.where(is_dbl, theta[GT[rows, np.where(is_dbl, donor2[cols], 0)]],
                  p1)
    p = 0.5 * (p1 + p2)
    ad = rng.binomial(dp, p)

    DP = sp.csc_matrix((dp.astype(np.float64), (rows, cols)),
                       shape=(n_var, n_cell))
    AD = sp.csc_matrix((ad.astype(np.float64), (rows, cols)),
                       shape=(n_var, n_cell))
    AD.eliminate_zeros()
    return dict(AD=AD, DP=DP, donor=donor, donor2=donor2, GT=GT)


def synth_pool_dense_device(n_var=30000, n_cell=100000, n_donor=16,
                            doublet_rate=0.0, density=0.01,
                            mean_extra_depth=0.6,
                            theta=(0.01, 0.5, 0.99), seed=0,
                            row_chunk=2000):
    """Sample the same generative model entirely ON DEVICE as dense
    int8 DenseCounts — no multi-GB host->device transfer.

    Statistically matches `synth_pool_counts` (same density, depth and
    genotype model); bytes differ (different RNG). Generation is
    chunked over variant rows to bound intermediate memory.
    """
    import jax
    import jax.numpy as jnp
    from ..ops.counts import DenseCounts

    key = jax.random.PRNGKey(seed)
    k_af, k_gt, k_donor, k_dbl, k_rows = jax.random.split(key, 5)

    af = jax.random.beta(k_af, 0.8, 0.8, shape=(n_var,))
    GT = jax.random.binomial(k_gt, 2, af[:, None],
                             shape=(n_var, n_donor)).astype(jnp.int8)
    donor = jax.random.randint(k_donor, (n_cell,), 0, n_donor)
    if doublet_rate > 0:
        is_dbl = jax.random.bernoulli(k_dbl, doublet_rate, (n_cell,))
        d2 = jax.random.randint(jax.random.fold_in(k_dbl, 1), (n_cell,),
                                0, n_donor)
        d2 = jnp.where(d2 == donor, (d2 + 1) % n_donor, d2)
        donor2 = jnp.where(is_dbl, d2, -1)
    else:
        donor2 = jnp.full((n_cell,), -1, jnp.int32)

    theta_arr = jnp.asarray(theta, jnp.float32)
    n_chunks = -(-n_var // row_chunk)
    n_var_pad = n_chunks * row_chunk
    GT_pad = jnp.zeros((n_var_pad, n_donor), jnp.int8).at[:n_var].set(GT)

    def gen_chunk(_, ci):
        kc = jax.random.fold_in(k_rows, ci)
        k1, k2, k3 = jax.random.split(kc, 3)
        r0 = ci * row_chunk
        gt_c = jax.lax.dynamic_slice(GT_pad, (r0, 0),
                                     (row_chunk, n_donor))      # (R, K)
        MAXD = 12  # depth cap; P(1+Poisson(0.6) > 12) is negligible
        covered = jax.random.bernoulli(k1, density,
                                       (row_chunk, n_cell))
        extra = jax.random.poisson(k2, mean_extra_depth,
                                   (row_chunk, n_cell), dtype=jnp.int32)
        dp = jnp.minimum(jnp.where(covered, 1 + extra, 0), MAXD)

        p1 = theta_arr[gt_c[:, donor]]                          # (R, C)
        d2c = jnp.where(donor2 >= 0, donor2, 0)
        p2 = jnp.where(donor2[None, :] >= 0, theta_arr[gt_c[:, d2c]], p1)
        p = 0.5 * (p1 + p2)

        # binomial via per-layer Bernoulli accumulation (bounds memory
        # to one (R, C) uniform draw at a time)
        def layer_body(l, acc):
            u = jax.random.uniform(jax.random.fold_in(k3, l),
                                   (row_chunk, n_cell))
            return acc + ((u < p) & (l < dp)).astype(jnp.int32)

        ad = jax.lax.fori_loop(0, MAXD, layer_body,
                               jnp.zeros((row_chunk, n_cell), jnp.int32))
        return None, (jnp.minimum(ad, 127).astype(jnp.int8),
                      jnp.minimum(dp, 127).astype(jnp.int8))

    @jax.jit
    def generate():
        _, (ad8, dp8) = jax.lax.scan(gen_chunk, None,
                                     jnp.arange(n_chunks))
        return (ad8.reshape(n_var_pad, n_cell),
                dp8.reshape(n_var_pad, n_cell))

    ad8, dp8 = generate()
    if n_var_pad != n_var:
        ad8, dp8 = ad8[:n_var], dp8[:n_var]
    counts = DenseCounts(ad8, dp8)
    return dict(counts=counts, donor=np.asarray(donor),
                donor2=np.asarray(donor2), GT=np.asarray(GT))


def write_cellsnp_dir(out_dir, AD, DP):
    """Write AD/DP (n_var, n_cell) as a minimal cellSNP_mat directory
    the readers and the `vireo -c` CLI accept: the two tag matrices,
    a sites VCF (chromosome 1, positions 1..n_var) and cell barcodes
    CELL000000-1, ...  Returns the barcodes."""
    import scipy.io
    import scipy.sparse as sp
    os.makedirs(out_dir, exist_ok=True)
    n_var, n_cell = AD.shape
    for tag, M in (("AD", AD), ("DP", DP)):
        scipy.io.mmwrite(os.path.join(out_dir, "cellSNP.tag.%s.mtx" % tag),
                         sp.coo_matrix(M), field="integer")
    with gzip.open(os.path.join(out_dir, "cellSNP.base.vcf.gz"),
                   "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.writelines("1\t%d\t.\tA\tC\t.\tPASS\t.\n" % (i + 1)
                     for i in range(n_var))
    barcodes = ["CELL%06d-1" % c for c in range(n_cell)]
    with open(os.path.join(out_dir, "cellSNP.samples.tsv"), "w") as f:
        f.writelines(b + "\n" for b in barcodes)
    return barcodes
