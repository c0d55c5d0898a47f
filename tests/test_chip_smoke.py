"""`chip_smoke.py` rehearsed on the CPU: every phase at a tiny size against
its NumPy oracle (the phases assert internally), the four-card phase on four
virtual CPU devices, and the refusal to run without a GPU. The full-size run
needs the card: `python -m pytest -m chip tests/` on a GPU machine."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless nvidia-smi lists a GPU (decided when the test runs)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
        [smi, "-L"], capture_output=True
    ).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize(
    "phase,kwargs",
    [
        ("poisson_mg_cg", {"n": 64}),
        ("imex_heat_step", {"n": 64}),
        ("jfnk_allen_cahn", {"n": 48}),
        ("sweeps_heat3d", {"n": 16, "k": 8}),
        ("single_apply", {"n2": 64, "n3": 16, "n_cg": 32, "calls": 2}),
    ],
)
def test_phase_tiny(phase, kwargs):
    rec = getattr(cs, phase)(**kwargs)
    if phase == "single_apply":
        assert set(rec) >= {"lap5", "adv4", "heat3d", "cg_plain"}
        assert all(rec[k]["max_abs_err"] <= 1e-4
                   for k in ("lap5", "adv4", "heat3d"))
        assert rec["cg_plain"]["iters"] > 0
    else:
        assert rec["limit"] > 0


def test_multichip_tiny():
    rec = cs.multichip(n=64, devices=jax.devices()[:4])
    rows = [v for v in rec.values() if isinstance(v, dict)]
    assert len(rows) == 10
    assert all(r["devices"] == 4 and r["rel_diff"] <= r["limit"] for r in rows)


def test_exits_nonzero_without_gpu():
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.chip
def test_full_size_on_gpu(gpu):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
