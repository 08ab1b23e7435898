"""Align donors by genotype across two VCFs — the donor_match
notebook workflow (reference examples/donor_match.ipynb) as a script.

Two routes, mirroring the notebook:
1) the wrap function `match_VCF_samples` (one call: intersect
   variants, Hungarian-align donor columns on mean absolute
   genotype-probability distance, vcf_utils.py:353-420);
2) the element functions (`load_VCF` + `parse_donor_GPb` +
   `match_SNPs` + `optimal_match`) for customised analyses.

The estimated-donor VCF comes from a seeded genotype-free vireo run on
the bundled demo data (regenerated on the fly unless OUT_DIR already
holds one), aligned against the bundled donor genotypes.

Usage: [JAX_PLATFORMS=cpu] python examples/donor_match_demo.py [out]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vireo_tpu.utils.platform import apply_compile_cache  # noqa: E402
apply_compile_cache()

DATA = "/root/reference/data"
out_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/vireo_donor_match"

# step 0: a genotype-free vireo run whose learned GT_donors VCF we
# will align (equivalent to `vireo -c data/cellSNP_mat -N 4 --randSeed 2`)
learned_vcf = os.path.join(out_dir, "GT_donors.vireo.vcf.gz")
if not os.path.exists(learned_vcf):
    from vireo_tpu.cli.vireo_cli import main as vireo_main
    vireo_main(["-c", DATA + "/cellSNP_mat", "-N", "4", "-o", out_dir,
                "--randSeed", "2", "--noPlot"])

# Option 1: the wrap function
from vireo_tpu.io.vcf import match_VCF_samples  # noqa: E402

res = match_VCF_samples(DATA + "/donors.cellSNP.vcf.gz", learned_vcf,
                        GT_tag1="PL", GT_tag2="PL")
print("\nmatched donors:",
      list(zip(res["matched_donors1"], res["matched_donors2"])))
print("mean GPb delta on the diagonal: %.4f"
      % float(np.mean(np.diag(res["matched_GPb_diff"]))))

# heatmap of the aligned genotype-probability differences
import matplotlib  # noqa: E402
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from vireo_tpu.plot.base_plot import heat_matrix  # noqa: E402

fig = plt.figure()
heat_matrix(res["matched_GPb_diff"], res["matched_donors1"],
            res["matched_donors2"])
plt.title("Geno Prob Delta: %d SNPs" % res["matched_n_var"])
plt.tight_layout()
fig.savefig(os.path.join(out_dir, "donor_match_delta.png"), dpi=120)
print("wrote", os.path.join(out_dir, "donor_match_delta.png"))

# Option 2: element functions for customised analysis
from vireo_tpu.io.vcf import load_VCF, parse_donor_GPb, match_SNPs  # noqa: E402
from vireo_tpu.ops.matching import optimal_match  # noqa: E402

vcf1 = load_VCF(DATA + "/donors.cellSNP.vcf.gz", biallelic_only=True,
                sparse=False, format_list=["PL"])
vcf2 = load_VCF(learned_vcf, biallelic_only=True, sparse=False,
                format_list=["PL"])
GPb1 = parse_donor_GPb(vcf1["GenoINFO"]["PL"], "PL")
GPb2 = parse_donor_GPb(vcf2["GenoINFO"]["PL"], "PL")

hit = match_SNPs(vcf2["variants"], vcf1["variants"])
in2 = np.flatnonzero(hit != None)  # noqa: E711
in1 = hit[in2].astype(int)
print("\nelement route: %d matched variants" % len(in2))

idx1, idx2, delta = optimal_match(GPb1[in1], GPb2[in2], axis=1,
                                  return_delta=True)
print("aligned donor columns:",
      [(np.array(vcf1["samples"])[i], np.array(vcf2["samples"])[j])
       for i, j in zip(idx1, idx2)])
assert np.array_equal(np.array(vcf1["samples"])[idx1],
                      res["matched_donors1"])
print("\ndonor_match demo OK")
