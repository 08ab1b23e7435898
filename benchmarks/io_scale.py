"""Host IO at scale: cellSNP-format directory read, native C++ parser
vs the reference's scipy.io.mmread path, on a north-star-sized pool.

Earlier rounds measured the native VCF parser only at demo size
(3,784 variants). This writes a full cellSNP_mat directory for a
synthetic 30k x 100k pool (~30M nonzeros) and times:

- vireo_tpu.io.matrices.read_cellSNP (native mtx/VCF readers,
  pure-Python fallback if the library is unavailable);
- the reference vireoSNP.utils.io_utils.read_cellSNP (mmread).

Prints one JSON line. Env: IO_VARS / IO_CELLS / IO_DENSITY, IO_DIR
(reuse an existing directory instead of regenerating).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n_var = int(os.environ.get("IO_VARS", 30_000))
    n_cell = int(os.environ.get("IO_CELLS", 100_000))
    density = float(os.environ.get("IO_DENSITY", 0.01))
    out_dir = os.environ.get(
        "IO_DIR", "/tmp/vireo_io_scale_%dx%d" % (n_var, n_cell))

    if not os.path.exists(os.path.join(out_dir, "cellSNP.tag.AD.mtx")):
        from vireo_tpu.sim.synth import synth_pool_counts, write_cellsnp_dir
        t0 = time.time()
        d = synth_pool_counts(n_var=n_var, n_cell=n_cell, n_donor=16,
                              doublet_rate=0.08, density=density, seed=0)
        gen_s = time.time() - t0
        t0 = time.time()
        write_cellsnp_dir(out_dir, d["AD"], d["DP"])
        write_s = time.time() - t0
        print("[io_scale] generated %.1fs, wrote %.1fs -> %s"
              % (gen_s, write_s, out_dir), file=sys.stderr)

    from vireo_tpu.io.fast import native_available
    from vireo_tpu.io.matrices import read_cellSNP

    t0 = time.time()
    ours = read_cellSNP(out_dir)
    t_ours = time.time() - t0
    nnz = int(ours["DP"].nnz)

    sys.path.insert(0, "/root/reference")
    from vireoSNP.utils.io_utils import read_cellSNP as ref_read
    t0 = time.time()
    ref = ref_read(out_dir)
    t_ref = time.time() - t0

    assert (ours["AD"] != ref["AD"]).nnz == 0, "AD mismatch vs reference"
    assert (ours["DP"] != ref["DP"]).nnz == 0, "DP mismatch vs reference"
    assert list(ours["samples"]) == list(ref["samples"])

    print(json.dumps({
        "metric": "read_cellSNP_%dkvar_x_%dkcell" % (n_var // 1000,
                                                     n_cell // 1000),
        "value": round(t_ours, 2),
        "unit": "s",
        "vs_baseline": round(t_ref / t_ours, 2),
        "reference_s": round(t_ref, 2),
        "nnz": nnz,
        "native": native_available(),
    }))


if __name__ == "__main__":
    main()
