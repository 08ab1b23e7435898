"""chip_smoke.py: its device check and its phases at a tiny size on the
CPU (the flagship size runs only on the card: `python chip_smoke.py`),
plus the `gpu`-marked run of its phases on a card."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def pool():
    return cs.make_pool(n_var=500, n_cell=240, n_donor=4, density=0.3,
                        doublet_rate=0.05, seed=0)


def test_device_check_exits_nonzero_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    # no result line on a machine without a card
    assert '"ok"' not in capsys.readouterr().out


def test_phase_rungs(pool):
    reports, kept = cs.phase_rungs(pool["AD"], pool["DP"], n_time=1)
    assert [r["rung"] for r in reports] == [
        "dense_int8", "packed", "coo", "int8_hybrid", "packed_hybrid"]
    for r in reports:
        assert r["rel_err"] <= r["tol"]
        assert r["suff_stats_ms"] > 0 and r["cell_loglik_ms"] > 0
    assert set(kept) == {"dense_int8"}


def test_phase_em(pool):
    counts = cs.build_rung("dense_int8", pool["AD"], pool["DP"])
    out = cs.phase_em(counts, 4, pool["donor"], iters=10)
    assert out["elbo_rel_diff"] <= 1e-4 and out["call_agreement"] >= 0.999


@pytest.mark.parametrize("x64", [False, True])
def test_phase_init(x64):
    """Device MT19937 init == host init bit for bit, in the card's f32
    mode and under x64."""
    import jax
    with jax.enable_x64(x64):
        assert cs.phase_init(60, 50, 3, n_init=3)


def test_phase_e2e(pool, tmp_path):
    out = cs.phase_e2e(pool, str(tmp_path), 4, runs=1, n_init=3,
                       extra_cli=["--nInit", "4"])
    assert len(out["cli_s"]) == 1 and out["library_s"] > 0
    assert (tmp_path / "vireo_0" / "donor_ids.tsv").exists()


def test_describe_dots_reads_types_and_precision():
    hlo = ("  %a = bf16[4,8]{1,0} parameter(0)\n"
           "  %b = f32[8,2]{1,0} parameter(1)\n"
           "  ROOT %d = f32[4,2]{1,0} dot(%a, %b), lhs_contracting_dims="
           "{1}, rhs_contracting_dims={0}, operand_precision={highest,"
           "highest}\n"
           "  %c = f32[4]{0} add(%x, %y)\n")
    lines = cs.describe_dots(hlo)
    assert lines == ["f32[4,2]{1,0} = dot(bf16[4,8]{1,0} x f32[8,2]{1,0}) "
                     "operand_precision={highest,highest}"]


@pytest.fixture
def gpu_devices():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda)")
    return devs


@pytest.mark.gpu
def test_phase_rungs_on_gpu(gpu_devices):
    pool = cs.make_pool(n_var=3000, n_cell=20000, n_donor=16,
                        density=0.01, doublet_rate=0.08, seed=0)
    reports, _ = cs.phase_rungs(pool["AD"], pool["DP"], n_time=3)
    assert all(r["rel_err"] <= r["tol"] for r in reports)
    assert np.isfinite([r["suff_stats_ms"] for r in reports]).all()
