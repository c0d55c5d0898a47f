"""Run every example end-to-end (reference tier-3 python demos, SURVEY §4 —
but executed in CI instead of by hand, so they cannot rot silently).

Each example runs in a fresh subprocess: examples mutate the global frontend
context and some configure JAX, so in-process execution would leak state
between cases. CPU platform, x64 on (the examples' accuracy checks are
double-precision).
"""

import os
import pathlib
import subprocess
import sys

import pytest

EXAMPLES_DIR = pathlib.Path(__file__).resolve().parent.parent / "examples"
EXAMPLES = sorted(p.name for p in EXAMPLES_DIR.glob("*.py"))


def test_every_example_is_covered():
    # if an example is added, this suite must know about it
    assert len(EXAMPLES) >= 9


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["NEPTUNE_TPU_X64"] = "1"
    r = subprocess.run(
        [
            sys.executable,
            "-c",
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            f"import runpy; runpy.run_path({str(EXAMPLES_DIR / name)!r}, "
            "run_name='__main__')",
        ],
        env=env,
        cwd=str(EXAMPLES_DIR.parent),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, (
        f"{name} failed (rc={r.returncode})\nstdout:\n{r.stdout[-2000:]}\n"
        f"stderr:\n{r.stderr[-2000:]}"
    )
    low = r.stdout.lower()
    assert "nan" not in low.split() and "inf" not in low.split(), (
        f"{name} printed non-finite values:\n{r.stdout[-2000:]}"
    )
