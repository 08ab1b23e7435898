"""vireo-tpu: a JAX-native genotype-donor deconvolution engine.

A from-scratch JAX/XLA framework with the capabilities of
single-cell-genetics/vireo (variational demultiplexing of pooled
single-cell RNA-seq, clone reconstruction, bulk deconvolution), designed
accelerator-first: jit-compiled coordinate-ascent VB over sparse allele-count
matrices, vmapped multi-init restarts, and cell-sharded data-parallel
execution over a `jax.sharding.Mesh`.

Public API mirrors the reference package surface
(/root/reference/vireoSNP/__init__.py:1-22) without copying its design:
the compute path here is pure-functional JAX, not NumPy objects.
"""

from .version import __version__

# submodule aliases mirroring the reference's surface
# (vireoSNP/__init__.py:3-5: `vcf`, `base`, `model`)
from .io import vcf
from . import base
from .models import vireo as model

from .ops.math import normalize, loglik_amplify, beta_entropy, get_binom_coeff
from .ops.matching import match, optimal_match, donor_select, get_confusion
from .ops.counts import (Counts, dense_counts, sparse_counts,
                         counts_from_scipy, HybridCounts)

from .models.vireo import Vireo
from .models.bmm import BinomMixtureVB
from .models.bulk import VireoBulk, LikRatio_test

from .engine.wrap import vireo_wrap

from .io.vcf import load_VCF, write_VCF, parse_donor_GPb, match_SNPs
from .io.matrices import read_cellSNP, read_vartrix

from . import plot

__all__ = [
    "__version__",
    "ops",
    "models",
    "engine",
    "io",
    "plot",
    "parallel",
]
