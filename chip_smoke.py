"""Bring-up check: vireo's main path on one GPU at its flagship width.

The deployment is BASELINE.json config 5: a synthetic pool of 30,000
variants x 100,000 cells x 16 donors, site density 0.01, doublet rate
0.08, made from a seed (`sim/synth.py`). Everything runs in ONE
process with one JAX client: a second JAX process on the card would
fail for want of memory, so the CLI is called in-process.

Phases (any failure exits non-zero; the result line is printed last):

1. device: JAX must find GPUs; the card's name and power limit, the
   device kind, the dense-layout memory budget and the native IO
   library's load status;
2. layout rungs (dense int8, int8 hybrid, packed, packed hybrid, COO)
   against the plain reference — f32 dense counts contracted at
   Precision.HIGHEST — at K=16, with contraction times and the matrix
   products XLA compiled;
3. a pinned 30-iteration EM fit from one init near the simulated
   truth, as shipped and under highest matmul precision;
4. the device MT19937 seeded init against the host init, bit for bit;
5. disk to answer: `vireo -c <cellSNP dir> -N 16 --randSeed 2` (default
   flags) twice, then one `vireo_wrap` library call, each scored
   against the simulated truth.

`--four-cards` runs only the multi-card path and what it is compared
with: `__graft_entry__.dryrun_multichip(4)`, then the flagship pool
through `vireo_wrap(mesh="auto")` on four cards against `mesh=None`
on card 0.

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import csv
import json
import os
import re
import shutil
import statistics
import time

import numpy as np

FLAGSHIP = dict(n_var=30_000, n_cell=100_000, n_donor=16, density=0.01,
                doublet_rate=0.08, seed=0)
K_TEST = 16
# every rung contracts at f32 accuracy (exact counts, f32 weights or
# their bf16 hi/lo split): relative Frobenius error against the f32
# reference
TOL = 1e-5
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".smoke_work")


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

def make_pool(n_var, n_cell, n_donor, density, doublet_rate, seed):
    from vireo_tpu.sim.synth import synth_pool_counts
    return synth_pool_counts(n_var=n_var, n_cell=n_cell, n_donor=n_donor,
                             doublet_rate=doublet_rate, density=density,
                             seed=seed)


def with_count_tail(AD, DP, frac=1e-3, seed=1):
    """AD/DP plus a planted tail of large counts (DP +200, AD +100 at a
    random `frac` of sites): drives the counts above the int8 and the
    nibble caps, the input of the hybrid rungs."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    V, C = DP.shape
    n = max(1, int(frac * DP.nnz))
    key = np.unique(rng.randint(0, V * C, size=n).astype(np.int64))
    rows, cols = key // C, key % C
    T = sp.csc_matrix((np.ones(len(key)), (rows, cols)), shape=(V, C))
    return (AD + 100 * T).tocsc(), (DP + 200 * T).tocsc()


def reference_counts(AD, DP):
    """The plain reference: f32 dense counts placed by a plain scatter
    (DenseCounts contracts f32 counts at Precision.HIGHEST)."""
    import jax.numpy as jnp
    from vireo_tpu.ops.counts import DenseCounts

    def dense(M):
        M = M.tocoo()
        return jnp.zeros(M.shape, jnp.float32).at[
            jnp.asarray(M.row), jnp.asarray(M.col)].set(
            jnp.asarray(M.data, jnp.float32))

    return DenseCounts(dense(AD), dense(DP))


def make_weights(n_var, n_cell, K, seed=0):
    """Weights shaped like the EM's: a row-stochastic cell posterior W
    and signed variant-side log weights Wa, Wd."""
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    W = rng.rand(n_cell, K)
    W /= W.sum(1, keepdims=True)
    Wa = -rng.gamma(2.0, 1.0, (n_var, K)) + rng.randn(n_var, K)
    Wd = -rng.gamma(2.0, 0.5, (n_var, K))
    return tuple(jnp.asarray(x, jnp.float32) for x in (W, Wa, Wd))


# ----------------------------------------------------------------------
# phase 2: layout rungs
# ----------------------------------------------------------------------

def median_time(fn, *args, n=7):
    """Median wall time of `n` calls, each ending in
    block_until_ready, after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def describe_dots(hlo_text):
    """The matrix products in a compiled program, one line each: result
    and operand types (the types the product ran in, after XLA's
    rewrites) and any precision or algorithm XLA recorded on it."""
    types, out = {}, []
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%(\S+) = (\([^=]*?\)|\S+) (.*)",
                     line)
        if not m:
            continue
        name, typ, rest = m.groups()
        types[name] = typ
        if not (rest.startswith("dot(") or "__cublas" in rest):
            continue
        ops = re.match(r"[\w-]+\(([^)]*)\)", rest)
        args = [types.get(a.strip().lstrip("%"), "?")
                for a in ops.group(1).split(",")] if ops else []
        keys = re.findall(r'operand_precision[^\]}]*[\]}]|algorithm[=":]+'
                          r'\w+|custom_call_target="[^"]+"', rest)
        out.append("%s = %s(%s) %s" % (typ, rest.split("(")[0],
                                       " x ".join(args), " ".join(keys)))
    return out


def rel_err(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def build_rung(name, AD, DP):
    """One ladder rung, forced through counts_from_scipy's explicit
    budget arguments; checks the ladder picked the named layout."""
    from vireo_tpu.ops.counts import (counts_from_scipy, DenseCounts,
                                      HybridCounts, SparseCounts)
    from vireo_tpu.ops.packed import PackedCounts
    n = AD.shape[0] * AD.shape[1]
    budget, kind, base = {
        "dense_int8": (4 * n, DenseCounts, None),
        "int8_hybrid": (3 * n, HybridCounts, DenseCounts),
        "packed": (1.5 * n, PackedCounts, None),
        "packed_hybrid": (1.5 * n, HybridCounts, PackedCounts),
        "coo": (0, SparseCounts, None),
    }[name]
    c = counts_from_scipy(AD, DP, max_dense_elems=0, dense_budget=budget)
    check(isinstance(c, kind), "%s: ladder built %s" % (
        name, type(c).__name__))
    if base is not None:
        check(isinstance(c.base, base), "%s: hybrid base is %s" % (
            name, type(c.base).__name__))
    if name == "dense_int8":
        check(c.ad.dtype == np.int8, "dense rung is %s" % c.ad.dtype)
    return c


def rung_report(name, counts, ref_out, weights, tol, n_time=7):
    """Contract one rung at K=16, compare with the reference outputs,
    time both contractions. Returns a dict of the numbers printed."""
    import jax
    W, Wa, Wd = weights
    suff = jax.jit(lambda c, w: c.suff_stats(w))
    loglik = jax.jit(lambda c, a, d: c.cell_loglik(a, d))
    S1, SS = suff(counts, W)
    LL = loglik(counts, Wa, Wd)
    err = max(rel_err(S1, ref_out[0]), rel_err(SS, ref_out[1]),
              rel_err(LL, ref_out[2]))
    t_suff = median_time(suff, counts, W, n=n_time)
    t_ll = median_time(loglik, counts, Wa, Wd, n=n_time)
    compiled = suff.lower(counts, W).compile()
    mem = compiled.memory_analysis()
    temp = getattr(mem, "temp_size_in_bytes", None)
    out = dict(rung=name, rel_err=err, tol=tol,
               suff_stats_ms=1e3 * t_suff, cell_loglik_ms=1e3 * t_ll,
               suff_stats_temp_bytes=temp)
    log("[phase 2] %-13s rel_frobenius_err=%.3e (tol %.0e)  "
        "suff_stats %.3f ms  cell_loglik %.3f ms  temp %s B"
        % (name, err, tol, out["suff_stats_ms"], out["cell_loglik_ms"],
           temp))
    for line in describe_dots(compiled.as_text()):
        log("[phase 2]   %s dot: %s" % (name, line))
    check(np.isfinite(err) and err <= tol,
          "%s: relative error %.3e above %.0e" % (name, err, tol))
    return out


def phase_rungs(AD, DP, K=K_TEST, n_time=7, keep=("dense_int8",)):
    """Phase 2. Returns (reports, kept rungs by name)."""
    import jax
    V, C = AD.shape
    weights = make_weights(V, C, K)
    W, Wa, Wd = weights
    AD2, DP2 = with_count_tail(AD, DP)
    reports, kept = [], {}
    for (A, D), names in (((AD, DP), ("dense_int8", "packed", "coo")),
                          ((AD2, DP2), ("int8_hybrid", "packed_hybrid"))):
        ref = reference_counts(A, D)
        ref_out = tuple(np.asarray(x) for x in
                        ref.suff_stats(W) + (ref.cell_loglik(Wa, Wd),))
        t_ref = median_time(jax.jit(lambda c, w: c.suff_stats(w)), ref, W,
                            n=n_time)
        log("[phase 2] reference f32 dense (HIGHEST) suff_stats %.3f ms"
            % (1e3 * t_ref))
        del ref
        for name in names:
            c = build_rung(name, A, D)
            reports.append(rung_report(name, c, ref_out, weights, TOL,
                                       n_time=n_time))
            if name in keep:
                kept[name] = c
            del c
    return reports, kept


# ----------------------------------------------------------------------
# phase 3: EM trajectory
# ----------------------------------------------------------------------

def phase_em(counts, n_donor, truth, iters=30, seed=3):
    """Phase 3: fit_vb pinned to `iters` iterations from one init, as
    shipped and under highest matmul precision.

    The init puts half of each cell's weight on its simulated donor
    (the rest uniform noise) and draws genotypes at random: from a
    fully random init at K=16 the first iterations sit near a saddle,
    where any rounding difference picks another local optimum, and the
    comparison would measure that lottery instead of the precision."""
    import jax
    import jax.numpy as jnp
    from vireo_tpu.models.vireo import (VireoConfig, init_state,
                                        default_priors, fit_vb)
    cfg = VireoConfig(n_var=counts.n_var, n_cell=counts.n_cell,
                      n_donor=n_donor)
    rng = np.random.RandomState(seed)
    id_init = 0.5 * np.eye(n_donor)[truth] + 0.5 * rng.rand(
        len(truth), n_donor)
    state = init_state(cfg, ID_prob_init=id_init, rng=rng,
                       dtype=jnp.float32)
    priors = default_priors(cfg, dtype=jnp.float32)
    kw = dict(min_iter=iters, max_iter=iters)
    t0 = time.time()
    res = fit_vb(counts, state, priors, cfg, **kw)
    e_ship = float(res.elbo_final)
    t_ship = time.time() - t0
    with jax.default_matmul_precision("highest"):
        res_h = fit_vb(counts, state, priors, cfg, **kw)
        e_high = float(res_h.elbo_final)
    rel = abs(e_ship - e_high) / abs(e_high)
    agree = float(np.mean(np.argmax(np.asarray(res.state.id_prob), 1)
                          == np.argmax(np.asarray(res_h.state.id_prob), 1)))
    tr, tr_h = np.asarray(res.elbo_trace), np.asarray(res_h.elbo_trace)
    log("[phase 3] ELBO trace as shipped %s" % np.array2string(
        tr, precision=1, max_line_width=10**6))
    log("[phase 3] ELBO trace at highest %s" % np.array2string(
        tr_h, precision=1, max_line_width=10**6))
    log("[phase 3] %d EM iterations: ELBO as shipped %.6f, at highest "
        "precision %.6f, relative difference %.3e; argmax donor calls "
        "agree on %.5f of cells (first fit incl. compile %.1f s)"
        % (iters, e_ship, e_high, rel, agree, t_ship))
    check(np.isfinite(e_ship) and rel <= 1e-4,
          "EM ELBO relative difference %.3e above 1e-4" % rel)
    check(agree >= 0.999, "EM donor calls agree on only %.5f" % agree)
    return dict(elbo_rel_diff=rel, call_agreement=agree)


# ----------------------------------------------------------------------
# phase 4: seeded init stream
# ----------------------------------------------------------------------

def phase_init(n_var, n_cell, n_donor, n_init=20, seed=2):
    """Phase 4: device MT19937 init == host np.random init, bitwise."""
    import jax.numpy as jnp
    from vireo_tpu.models.vireo import VireoConfig
    from vireo_tpu.engine.wrap import _host_batched_init, _mt_batched_init
    cfg = VireoConfig(n_var=n_var, n_cell=n_cell, n_donor=n_donor)
    host = _host_batched_init(cfg, n_init, None,
                              np.random.RandomState(seed), jnp.float32)
    dev = _mt_batched_init(cfg, n_init, None, np.random.RandomState(seed),
                           jnp.float32)
    for field in ("id_prob", "gt_prob", "beta_mu", "beta_sum"):
        a = np.asarray(getattr(host, field))
        b = np.asarray(getattr(dev, field))
        check(a.dtype == b.dtype == np.float32 and a.shape == b.shape,
              "init %s: %s%s vs %s%s" % (field, a.dtype, a.shape, b.dtype,
                                         b.shape))
        n_diff = int(np.sum(a.view(np.uint32) != b.view(np.uint32)))
        log("[phase 4] init %-8s %s: %d of %d values differ bitwise"
            % (field, a.shape, n_diff, a.size))
        check(n_diff == 0, "device init %s differs from host" % field)
    return True


# ----------------------------------------------------------------------
# phase 5: disk to answer
# ----------------------------------------------------------------------

def read_donor_calls(path):
    with open(path) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return [r["donor_id"] for r in rows]


def n_vars_of(pool):
    """Covered variants per cell, as the CLI counts them."""
    return np.asarray((pool["DP"] > 0).sum(axis=0)).reshape(-1)


def singlet_accuracy(calls, donor_names, truth, truth2):
    """Share of true singlets called to their own donor, donors aligned
    to the truth by ops.matching.optimal_match."""
    from vireo_tpu.ops.matching import optimal_match
    K = len(donor_names)
    idx = {d: i for i, d in enumerate(donor_names)}
    called = np.zeros((len(calls), K))
    for i, c in enumerate(calls):
        if c in idx:
            called[i, idx[c]] = 1.0
    singlet = truth2 < 0
    _, perm = optimal_match(np.eye(K)[truth[singlet]], called[singlet],
                            axis=1)
    got = called[singlet][:, perm]
    return float(np.mean((got.sum(1) == 1)
                         & (np.argmax(got, 1) == truth[singlet])))


def phase_e2e(pool, work_dir, n_donor, runs=2, n_init=20,
              extra_cli=()):
    """Phase 5: the CLI from a cellSNP directory, then one library
    call; each must call >= 99% of true singlets correctly."""
    import jax
    from vireo_tpu.sim.synth import write_cellsnp_dir
    from vireo_tpu.cli import vireo_cli
    from vireo_tpu.engine.wrap import vireo_wrap
    from vireo_tpu.io.matrices import donor_calls

    names = ["donor%d" % k for k in range(n_donor)]
    truth, truth2 = pool["donor"], pool["donor2"]
    cell_dir = os.path.join(work_dir, "cellsnp")
    t0 = time.time()
    write_cellsnp_dir(cell_dir, pool["AD"], pool["DP"])
    log("[phase 5] wrote the cellSNP directory in %.1f s"
        % (time.time() - t0))
    out = dict(cli_s=[])
    for r in range(runs):
        out_dir = os.path.join(work_dir, "vireo_%d" % r)
        t0 = time.time()
        vireo_cli.main(["-c", cell_dir, "-N", str(n_donor), "-o", out_dir,
                        "--randSeed", "2"] + list(extra_cli))
        dt = time.time() - t0
        acc = singlet_accuracy(
            read_donor_calls(os.path.join(out_dir, "donor_ids.tsv")),
            names, truth, truth2)
        out["cli_s"].append(dt)
        log("[phase 5] CLI run %d (%s): %.1f s disk to donor_ids.tsv, "
            "true singlets called correctly %.5f"
            % (r + 1, "compiling" if r == 0 else "warm", dt, acc))
        check(acc >= 0.99, "CLI singlet accuracy %.5f < 0.99" % acc)

    t0 = time.time()
    res = vireo_wrap(pool["AD"], pool["DP"], n_donor=n_donor,
                     n_init=n_init, check_doublet=True, timing=True)
    dt = time.time() - t0
    acc = singlet_accuracy(donor_calls(res, names, n_vars_of(pool)),
                           names, truth, truth2)
    out["library_s"] = dt
    log("[phase 5] vireo_wrap(n_init=%d, check_doublet=True): %.1f s, "
        "true singlets called correctly %.5f" % (n_init, dt, acc))
    check(acc >= 0.99, "library singlet accuracy %.5f < 0.99" % acc)
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log("[phase 5] device peak_bytes_in_use %s" % out["peak_bytes_in_use"])
    return out


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------

def four_cards(pool, n_donor, n_init=20):
    """The multi-card path: the dryrun's four sharded rungs against
    single-device fits, then the flagship pool sharded over four cards
    against card 0 alone."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vireo_tpu.engine.wrap import vireo_wrap
    from vireo_tpu.ops.counts import counts_from_scipy
    from vireo_tpu.io.matrices import donor_calls
    from vireo_tpu.ops.matching import optimal_match
    from vireo_tpu.parallel.mesh import make_mesh, CELL_AXIS
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)

    # the dense GSPMD rung must split the counts over the four cards
    mesh = make_mesh(4)
    c = counts_from_scipy(pool["AD"], pool["DP"],
                          sharding=NamedSharding(mesh, P(None, CELL_AXIS)))
    shards = [(s.device.id, s.data.shape) for s in c.ad.addressable_shards]
    log("[four cards] dense counts %s %s sharded as %s"
        % (c.ad.dtype, c.ad.shape, shards))
    check(len({d for d, _ in shards}) == 4
          and all(s[1] == c.ad.shape[1] // 4 for _, s in shards),
          "dense counts are not split over four cards: %s" % shards)
    del c

    kw = dict(n_donor=n_donor, n_init=n_init, random_seed=2,
              check_doublet=True)
    t0 = time.time()
    res_m = vireo_wrap(pool["AD"], pool["DP"], mesh="auto", **kw)
    t_m = time.time() - t0
    t0 = time.time()
    res_1 = vireo_wrap(pool["AD"], pool["DP"], mesh=None, **kw)
    t_1 = time.time() - t0
    # donor labels aligned by genotype; the donor call is donor_ids.tsv's
    # (the doublet column is a max over pairs, so labels do not enter)
    perm = optimal_match(res_1["GT_prob"], res_m["GT_prob"])[1]
    aligned = dict(res_m, ID_prob=res_m["ID_prob"][:, perm])
    names = ["donor%d" % k for k in range(n_donor)]
    n_vars = n_vars_of(pool)
    agree = float(np.mean(donor_calls(aligned, names, n_vars)
                          == donor_calls(res_1, names, n_vars)))
    argmax_agree = float(np.mean(np.argmax(aligned["ID_prob"], 1)
                                 == np.argmax(res_1["ID_prob"], 1)))
    log("[four cards] vireo_wrap mesh=auto on %d cards %.1f s, mesh=None "
        "on card 0 %.1f s (first calls, compile included); donor calls "
        "(donor_ids.tsv) agree on %.6f of cells, singlet-posterior "
        "argmax on %.6f" % (len(jax.devices()), t_m, t_1, agree,
                            argmax_agree))
    check(agree == 1.0, "four-card donor calls agree on %.6f" % agree)


# ----------------------------------------------------------------------

def device_report():
    """Phase 1: exits (SystemExit, non-zero) unless JAX finds GPUs."""
    from vireo_tpu.utils.platform import (require_gpu,
                                          card_name_and_power_limit)
    devs = require_gpu()
    from vireo_tpu.ops.counts import device_dense_budget
    from vireo_tpu.io._native import build as native
    log(card_name_and_power_limit())
    log("[phase 1] devices: %d x %s (platform %s)"
        % (len(devs), devs[0].device_kind, devs[0].platform))
    log("[phase 1] device_dense_budget %.0f bytes (%.2f GiB)"
        % (device_dense_budget(), device_dense_budget() / 2**30))
    lib = native.lib()
    log("[phase 1] native IO library: %s"
        % (("loaded " + native.so_path()) if lib is not None
           else "NOT loaded (pure-Python readers)"))
    return devs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and its comparison")
    args = ap.parse_args(argv)

    devs = device_report()
    from vireo_tpu.utils.platform import apply_compile_cache
    apply_compile_cache()
    if args.four_cards:
        check(len(devs) >= 4, "--four-cards needs 4 GPUs, found %d"
              % len(devs))

    t0 = time.time()
    pool = make_pool(**FLAGSHIP)
    log("[data] pool %dx%dx%d, %d nonzeros, made in %.1f s"
        % (FLAGSHIP["n_var"], FLAGSHIP["n_cell"], FLAGSHIP["n_donor"],
           pool["DP"].nnz, time.time() - t0))
    K = FLAGSHIP["n_donor"]
    if args.four_cards:
        four_cards(pool, K)
    else:
        os.makedirs(WORK_DIR, exist_ok=True)
        try:
            _, kept = phase_rungs(pool["AD"], pool["DP"])
            phase_em(kept.pop("dense_int8"), K, pool["donor"])
            phase_init(FLAGSHIP["n_var"], FLAGSHIP["n_cell"], K)
            phase_e2e(pool, WORK_DIR, K)
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
