"""chip_smoke.py on the CPU: it refuses a non-GPU backend, and each phase's
function runs at a tiny size (kernels in interpret mode)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs
from neutfem_jax import config

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def float32():
    """The phases run in float32 as on the card; the suite's float64 setting
    comes back afterwards."""
    x64 = config.x64_enabled()
    config.set_x64(False)
    yield
    config.set_x64(x64)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


def test_refuses_non_gpu_backend():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_cpu_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_refuses_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_phase_kernels_tiny(float32):
    lines = cs.phase_kernels(shape=(5, 6, 7), interpret=True, reps=1)
    assert [(l["kernel"], l["direction"]) for l in lines] == [
        (k, d) for d in "zyx" for k in ("thomas_solve", "fused_schur_dir")]
    for l in lines:
        assert l["max_rel_err"] <= l["tol"] and l["device"]["platform"] == "cpu"
        json.dumps(l)


def test_thomas_tolerance():
    # 4 n u kappa: linear in the line length and the condition number
    assert cs.thomas_tolerance(100, 4.0) == pytest.approx(4 * 100 * 2.0 ** -24 * 4)
    assert cs.thomas_tolerance(200, 4.0) == 2 * cs.thomas_tolerance(100, 4.0)


def test_phase_headline_tiny(float32):
    line = cs.phase_headline(mesh=(1, 1), pcm_limit=None, ab_reps=1)
    assert not config.x64_enabled()  # the float64 solve restored float32
    assert line["outers"] < cs.HEADLINE_TOL[3] and line["n_cells"] == 19 ** 3
    assert line["dtype"] == "float32"
    _check_ab(line)
    assert "temp_size_in_bytes" in line["memory"]


def _check_ab(line):
    """One rep of each A/B variant, with the counts behind its ms/outer; on the
    CPU both variants run the scan, so the counts agree."""
    for label in ("kernels", "xla"):
        for m in ("ms_per_outer", "ms_per_inner", "outers", "inners"):
            assert len(line[f"{m}_{label}"]) == 1
        assert line[f"outers_{label}"][0] == line["outers"]
    assert line["ab_counts_agree"] is True


def test_phase_rt1_tiny(float32):
    line = cs.phase_rt1(mesh=(1, 1), ab_reps=1)
    assert line["rt"] == "RT1-P1" and line["outers"] < 120


def test_phase_koeberg_tiny(float32):
    line = cs.phase_koeberg(mesh_n=1, pcm_limit=None, ab_reps=1)
    assert line["groups"] == 4 and line["outers"] < cs.HEADLINE_TOL[3]
    _check_ab(line)


def test_phase_adjoint_tiny(float32):
    line = cs.phase_adjoint(mesh=(1, 1))
    assert line["abs_diff"] <= line["tol_keff"]


def test_phase_multi_on_virtual_devices(float32):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh")
    line = cs.phase_multi(mesh=(1, 4), n_devices=4)
    assert line["flux_devices"] == 4
