"""`vireo` command-line entry point.

Flag-compatible with the reference CLI
(/root/reference/vireoSNP/vireo.py:30-247): same inputs (cellSNP dir,
cell VCF, vartrix), same five donor-genotype modes, same outputs
(donor_ids.tsv, summary.tsv, prob_*.tsv.gz, GT_donors.vireo.vcf.gz,
figures) — so the reference's demo.sh runs unchanged against this
engine.
"""

import os
import sys
import time
import argparse

import numpy as np

from ..version import __version__
from ..ops.matching import optimal_match
from ..engine.wrap import vireo_wrap
from ..plot.base_plot import plot_GT
from ..io.matrices import (match_donor_VCF, write_donor_id, read_cellSNP,
                           read_vartrix)
from ..io.vcf import (load_VCF, write_VCF, parse_donor_GPb,
                      read_sparse_GeneINFO, GenoINFO_maker)

START_TIME = time.time()


def build_parser():
    parser = argparse.ArgumentParser(
        prog="vireo", description="vireo-tpu donor demultiplexing v%s"
        % __version__)
    parser.add_argument("--cellData", "-c", dest="cell_data", default=None,
                        help="The cell genotype file in VCF format or "
                             "cellSNP folder with sparse matrices.")
    parser.add_argument("--nDonor", "-N", type=int, dest="n_donor",
                        default=None,
                        help="Number of donors to demultiplex; can be "
                             "larger than provided in donor_file")
    parser.add_argument("--outDir", "-o", dest="out_dir", default=None,
                        help="Directory for output files "
                             "[default: $cellFilePath/vireo]")
    parser.add_argument("--vartrixData", dest="vartrix_data", default=None,
                        help="The cell genotype files in vartrix outputs "
                             "(three/four files, comma separated): "
                             "alt.mtx,ref.mtx,barcodes.tsv,SNPs.vcf.gz")
    parser.add_argument("--donorFile", "-d", dest="donor_file", default=None,
                        help="The donor genotype file in VCF format.")
    parser.add_argument("--genoTag", "-t", dest="geno_tag", default='PL',
                        help="The tag for donor genotype: GT, GP, PL "
                             "[default: %(default)s]")
    parser.add_argument("--noDoublet", dest="no_doublet",
                        action="store_true", default=False,
                        help="If use, not checking doublets.")
    parser.add_argument("--nInit", "-M", type=int, dest="n_init", default=50,
                        help="Number of random initializations "
                             "[default: %(default)s]")
    parser.add_argument("--extraDonor", type=int, dest="n_extra_donor",
                        default=0,
                        help="Number of extra donors in pre-cluster "
                             "[default: %(default)s]")
    parser.add_argument("--extraDonorMode", dest="extra_donor_mode",
                        default="distance",
                        help="Method for searching from extra donors: "
                             "size or distance [default: %(default)s]")
    parser.add_argument("--forceLearnGT", dest="force_learnGT",
                        default=False, action="store_true",
                        help="If use, treat donor GT as prior only.")
    parser.add_argument("--ASEmode", dest="ASE_mode", default=False,
                        action="store_true",
                        help="If use, turn on SNP-specific allelic ratio.")
    parser.add_argument("--noPlot", dest="no_plot", default=False,
                        action="store_true",
                        help="If use, turn off plotting GT distance.")
    parser.add_argument("--randSeed", type=int, dest="rand_seed",
                        default=None,
                        help="Seed for random initialization "
                             "[default: %(default)s]")
    parser.add_argument("--cellRange", type=str, dest="cell_range",
                        default=None,
                        help="Range of cells to process, e.g. 0-10000 "
                             "[default: all]")
    parser.add_argument("--callAmbientRNAs", dest="check_ambient",
                        default=False, action="store_true",
                        help="If use, detect ambient RNAs in each cell")
    parser.add_argument("--ambientMinGain", type=float,
                        dest="ambient_min_gain", default=None,
                        help="Min per-SNP ELBO gain for the ambient-RNA "
                             "EM (reference default sqrt(n_cell)/3, "
                             "vireo_doublet.py:230-240; raise to trade "
                             "weakly-informative SNPs for speed) "
                             "[default: sqrt(n_cell)/3]")
    parser.add_argument("--nproc", "-p", type=int, dest="nproc", default=1,
                        help="Accepted for compatibility; restarts are "
                             "batched on device [default: %(default)s]")
    parser.add_argument("--checkpointDir", dest="checkpoint_dir",
                        default=None,
                        help="Directory for phase checkpoints; an "
                             "interrupted run restarted with the same "
                             "arguments resumes after the last completed "
                             "phase [default: off]")
    parser.add_argument("--timing", dest="timing", default=False,
                        action="store_true",
                        help="Print a per-phase timing summary "
                             "(also VIREO_TIMING=1)")
    parser.add_argument("--mesh", dest="mesh", default="auto",
                        help="Device mesh for sharding the cell axis: "
                             "'auto' (all local devices for big "
                             "pools), 'off', or 'VxC' for a 2-D "
                             "vars-x-cells capacity mesh, e.g. '2x4' "
                             "[default: %(default)s]")
    return parser


def _resolve_cli_mesh(spec):
    """--mesh auto|off|VxC -> the vireo_wrap mesh argument."""
    spec = (spec or "auto").strip().lower()
    if spec == "auto":
        return "auto"
    if spec in ("off", "none", "0", "no"):
        return None
    from ..parallel.mesh import make_mesh2d
    nv, nc = (int(s) for s in spec.split("x"))
    return make_mesh2d(nv, nc)


def main(argv=None):
    from ..utils.platform import apply_compile_cache
    apply_compile_cache()

    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        print("Welcome to vireo-tpu v%s!\n" % __version__)
        print("use -h or --help for help on argument.")
        sys.exit(1)
    options = build_parser().parse_args(argv)

    # out directory (vireo.py:95-107)
    if options.out_dir is None:
        print("Warning: no outDir provided, we use $cellFilePath/vireo.")
        input_path = options.cell_data
        if input_path is None and options.vartrix_data is not None:
            input_path = options.vartrix_data.split(",")[0]
        out_dir = os.path.dirname(os.path.abspath(input_path)) + "/vireo"
    elif os.path.dirname(options.out_dir) == "":
        out_dir = "./" + options.out_dir
    else:
        out_dir = options.out_dir
    if not os.path.exists(out_dir):
        os.makedirs(out_dir, exist_ok=True)

    # input data (vireo.py:109-133)
    if options.cell_data is None and options.vartrix_data is None:
        print("Error: need cell data in vcf file, or cellSNP output "
              "folder, or vartrix's alt.mtx,ref.mtx,barcodes.tsv.")
        sys.exit(1)
    elif options.vartrix_data is not None:
        print("[vireo] Loading vartrix files ...")
        vartrix_files = options.vartrix_data.split(",")
        if len(vartrix_files) < 3 or len(vartrix_files) > 4:
            print("Error: vartrixData requires 3 or 4 comma separated files")
            sys.exit(1)
        elif len(vartrix_files) == 3:
            vartrix_files.append(None)
        cell_dat = read_vartrix(vartrix_files[0], vartrix_files[1],
                                vartrix_files[2], vartrix_files[3])
    elif os.path.isdir(os.path.abspath(options.cell_data)):
        print("[vireo] Loading cell folder ...")
        cell_dat = read_cellSNP(options.cell_data)
    else:
        print("[vireo] Loading cell VCF file ...")
        from ..io.fast import load_cell_vcf_fast
        cell_dat = load_cell_vcf_fast(options.cell_data,
                                      tags=("AD", "DP"),
                                      biallelic_only=True)
        if cell_dat is None:  # no native toolchain: pure-Python path
            cell_vcf = load_VCF(options.cell_data, biallelic_only=True)
            cell_dat = read_sparse_GeneINFO(cell_vcf['GenoINFO'],
                                            keys=['AD', 'DP'])
            for _key in ['samples', 'variants', 'FixedINFO', 'contigs',
                         'comments']:
                cell_dat[_key] = cell_vcf[_key]

    # subset cells (vireo.py:136-142)
    if options.cell_range is not None:
        lo, hi = (int(x) for x in options.cell_range.split("-"))
        cell_dat['AD'] = cell_dat['AD'][:, lo:hi]
        cell_dat['DP'] = cell_dat['DP'][:, lo:hi]
        cell_dat['samples'] = cell_dat['samples'][lo:hi]

    if cell_dat['AD'].shape[0] == 0:
        print("Error: cell data contains no variants.")
        sys.exit(1)

    # donor genotype (vireo.py:149-189)
    n_donor = options.n_donor
    donor_vcf = None
    if options.donor_file is not None:
        if "variants" not in cell_dat.keys():
            print("Error: No variants information is loaded, please "
                  "provide base.vcf.gz")
            sys.exit(1)

        print("[vireo] Loading donor VCF file ...")
        donor_vcf = load_VCF(options.donor_file, biallelic_only=True,
                             sparse=False,
                             format_list=[options.geno_tag])

        if (donor_vcf['n_SNP_tagged'][0] <
                (0.1 * len(donor_vcf['GenoINFO'][options.geno_tag]))):
            print("Error: No " + options.geno_tag + " tag in donor "
                  "genotype; please try another tag for genotype, e.g., GT")
            print("        %s" % options.donor_file)
            sys.exit(1)

        cell_dat, donor_vcf = match_donor_VCF(cell_dat, donor_vcf)
        if len(donor_vcf['GenoINFO'][options.geno_tag]) == 0:
            print("Error: No matching variants found between cell data "
                  "and donor VCF.")
            sys.exit(1)

        donor_GPb = parse_donor_GPb(
            donor_vcf['GenoINFO'][options.geno_tag], options.geno_tag)

        if n_donor is None or n_donor == donor_GPb.shape[1]:
            n_donor = donor_GPb.shape[1]
            donor_names = donor_vcf['samples']
            learn_GT = False
        elif n_donor < donor_GPb.shape[1]:
            learn_GT = False
            donor_names = ['donor%d' % x for x in range(n_donor)]
        else:
            learn_GT = True
            donor_names = (donor_vcf['samples'] +
                           ['donor%d' % x
                            for x in range(donor_GPb.shape[1], n_donor)])
    else:
        learn_GT = True
        donor_GPb = None
        donor_names = ['donor%d' % x for x in range(n_donor)]

    import scipy.sparse as sp
    n_vars = np.array(
        (cell_dat['DP'] > 0).sum(axis=0)).reshape(-1) \
        if sp.issparse(cell_dat['DP']) \
        else np.sum(cell_dat['DP'] > 0, axis=0)

    if options.force_learnGT:
        learn_GT = True

    # extra donors (vireo.py:196-202)
    n_extra_donor = 0
    if learn_GT:
        if options.n_extra_donor is None or options.n_extra_donor == "None":
            n_extra_donor = int(round(np.sqrt(n_donor)))
        else:
            n_extra_donor = options.n_extra_donor

    n_init = options.n_init if learn_GT else 1
    check_doublet = options.no_doublet is False

    print("[vireo] Demultiplex %d cells to %d donors with %d variants."
          % (cell_dat['AD'].shape[1], n_donor, cell_dat['AD'].shape[0]))
    res_vireo = vireo_wrap(
        cell_dat['AD'], cell_dat['DP'], n_donor=n_donor,
        GT_prior=donor_GPb, learn_GT=learn_GT, n_init=n_init,
        n_extra_donor=n_extra_donor,
        extra_donor_mode=options.extra_donor_mode,
        check_doublet=check_doublet, random_seed=options.rand_seed,
        ASE_mode=options.ASE_mode, check_ambient=options.check_ambient,
        ambient_min_gain=options.ambient_min_gain,
        nproc=options.nproc, checkpoint_dir=options.checkpoint_dir,
        timing=options.timing or None,
        mesh=_resolve_cli_mesh(options.mesh))

    import contextlib
    from ..utils.timing import PhaseTimer
    # same knob resolution as vireo_wrap: --timing OR VIREO_TIMING=1
    timing_on = options.timing or os.environ.get(
        "VIREO_TIMING", "0").lower() not in ("0", "", "no", "off")
    tail_timer = PhaseTimer() if timing_on else None

    def phase(name):
        return tail_timer.phase(name) if tail_timer \
            else contextlib.nullcontext()

    if (n_donor is not None and donor_GPb is not None
            and n_donor < donor_GPb.shape[1]):
        idx = optimal_match(res_vireo['GT_prob'], donor_GPb)[1]
        donor_names = [donor_vcf['samples'][x] for x in idx]

    with phase("result_writers"):
        write_donor_id(out_dir, donor_names, cell_dat['samples'], n_vars,
                       res_vireo)

    want_plot = options.no_plot is False and options.vartrix_data is None
    if want_plot:
        try:
            import matplotlib  # noqa: F401  (optional: setup.py "plot")
        except ImportError:
            print("[vireo] matplotlib is not installed; skipping the "
                  "GT-distance figure")
            want_plot = False
    if want_plot:
        with phase("plots"):
            dp_sum = np.array(cell_dat['DP'].sum(axis=1)).reshape(-1) \
                if sp.issparse(cell_dat['DP']) \
                else cell_dat['DP'].sum(axis=1)
            idx = dp_sum > (3 * n_donor)
            if learn_GT and donor_GPb is not None:
                plot_GT(out_dir, res_vireo['GT_prob'][idx, :, :],
                        donor_names, donor_GPb[idx, :, :],
                        donor_vcf['samples'])
            else:
                plot_GT(out_dir, res_vireo['GT_prob'][idx, :, :],
                        donor_names)

    # inferred donor genotype (vireo.py:236-242)
    if learn_GT and 'variants' in cell_dat.keys():
        with phase("donor_vcf"):
            donor_vcf_out = cell_dat
            donor_vcf_out['samples'] = donor_names
            donor_vcf_out['GenoINFO'] = GenoINFO_maker(
                res_vireo['GT_prob'],
                cell_dat['AD'] @ res_vireo['ID_prob'],
                cell_dat['DP'] @ res_vireo['ID_prob'])
            write_VCF(out_dir + "/GT_donors.vireo.vcf.gz", donor_vcf_out)
    if tail_timer is not None:
        print(tail_timer.summary())

    run_time = time.time() - START_TIME
    print("[vireo] All done: %d min %.1f sec"
          % (int(run_time / 60), run_time % 60))
    print()


if __name__ == "__main__":
    main()
