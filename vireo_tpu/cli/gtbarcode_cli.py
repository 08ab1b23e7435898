"""`GTbarcode` command-line entry point.

Flag-compatible with the reference
(/root/reference/vireoSNP/GTbarcode.py:16-121): loads a donor VCF,
filters variants on INFO coverage, greedily selects discriminatory
variants and writes GTbarcode.tsv plus the mini-code figure.
"""

import os
import sys
import argparse

import numpy as np

from ..version import __version__
from ..plot.base_plot import minicode_plot
from ..models.variant_select import variant_select
from ..io.vcf import load_VCF, parse_donor_GPb


def build_parser():
    parser = argparse.ArgumentParser(
        prog="GTbarcode",
        description="vireo-tpu genotype barcode generator v%s" % __version__)
    parser.add_argument("--vcfFile", "-i", dest="vcf_file", default=None,
                        help="The VCF file for genotype of samples")
    parser.add_argument("--outFile", "-o", dest="out_file", default=None,
                        help="Output file [default: $vcfFile/GTbarcode.tsv]")
    parser.add_argument("--genoTag", "-t", dest="geno_tag", default='GT',
                        help="The tag for donor genotype: GT, GP, PL "
                             "[default: %(default)s]")
    parser.add_argument("--noHomoAlt", dest="no_homo_alt", default=False,
                        action="store_true",
                        help="Filter out variants with homozygous ALT.")
    parser.add_argument("--noPlot", dest="no_plot", default=False,
                        action="store_true",
                        help="Turn off the plot for the barcode.")
    parser.add_argument("--figSize", dest="fig_size", default="4,2",
                        help="Size for the output figure, comma separated "
                             "[default: %(default)s].")
    parser.add_argument("--figFormat", dest="fig_format", default="png",
                        help="Format of output figure: png or pdf "
                             "[default: %(default)s].")
    parser.add_argument("--randSeed", type=int, dest="rand_seed",
                        default=None,
                        help="Seed for random pick among equal-information "
                             "variants [default: %(default)s]")
    return parser


def main(argv=None):
    from ..utils.platform import apply_compile_cache
    apply_compile_cache()
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        print("Welcome to GT barcode generator; vireo-tpu v%s!\n"
              % __version__)
        print("use -h or --help for help on argument.")
        sys.exit(1)
    options = build_parser().parse_args(argv)

    if options.vcf_file is None:
        print("Error: need genotype data in vcf file.")
        sys.exit(1)
    vcf_file = options.vcf_file

    if options.out_file is None:
        print("Warning: no outFile provided, we use $vcfFile/GTbarcode.tsv")
        out_file = (os.path.dirname(os.path.abspath(vcf_file))
                    + "/GTbarcode.tsv")
    else:
        out_file = options.out_file
    out_parent = os.path.dirname(out_file)
    if out_parent and not os.path.exists(out_parent):
        os.makedirs(out_parent, exist_ok=True)

    geno_tag = options.geno_tag
    donor_vcf = load_VCF(vcf_file, sparse=False, biallelic_only=True)
    donor_GPb = parse_donor_GPb(donor_vcf['GenoINFO'][geno_tag], geno_tag)

    var_ids = np.array(donor_vcf["variants"])
    GT_vals = np.argmax(donor_GPb, axis=2)
    sample_ids = donor_vcf['samples']

    # parse INFO AD/DP/OTH (GTbarcode.py:76-93)
    INFO = donor_vcf["FixedINFO"]["INFO"]

    def info_val(s, tag):
        if s.count(tag + "=") == 0:
            return 0.0
        return float(s.split(tag + "=")[1].split(";")[0])

    AD = np.array([info_val(s, "AD") for s in INFO])
    DP = np.array([info_val(s, "DP") for s in INFO])
    OTH = np.array([info_val(s, "OTH") for s in INFO])

    # filtering (GTbarcode.py:96-101)
    with np.errstate(divide='ignore', invalid='ignore'):
        idx = (DP > 20) * (OTH / DP < 0.05)
    if options.no_homo_alt:
        idx *= np.max(GT_vals, axis=1) < 2

    AD, DP, OTH = AD[idx], DP[idx], OTH[idx]
    var_ids, GT_vals = var_ids[idx], GT_vals[idx, :]

    res_barcodes = variant_select(GT_vals, DP, rand_seed=options.rand_seed)
    with open(out_file, "w") as fid:
        fid.write("\t".join(["variants"] + list(sample_ids)) + "\n")
        for i in res_barcodes[2]:
            line_list = [var_ids[i]] + ["%d" % x for x in GT_vals[i, :]]
            fid.write("\t".join(line_list) + "\n")

    if options.no_plot is False:
        fig_size = np.array(options.fig_size.split(","), float)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(fig_size[0], fig_size[1]), dpi=300)
        minicode_plot(res_barcodes[1], var_ids[res_barcodes[2]],
                      donor_vcf['samples'])
        plt.tight_layout()
        fig.savefig(".".join(out_file.split(".")[:-1]) + "."
                    + options.fig_format)


if __name__ == "__main__":
    main()
