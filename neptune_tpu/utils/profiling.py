"""Profiling + solver observability.

The reference's only observability is PETSc's per-solve convergence printout
(iterations / residual norm / converged reason, `NeptunePETScRuntime.cpp:
345-359, 402-416`) and stderr arg dumps. Equivalents here:

  * ``report_solve`` — jit-safe convergence reporting via jax.debug.print
    (enabled per-op with verbose=True or globally with NEPTUNE_TPU_VERBOSE=1);
  * ``trace`` — a context manager around jax.profiler for device traces
    (view with TensorBoard / xprof);
  * ``annotate`` — named trace spans for phases of a solver program.
"""

from __future__ import annotations

import contextlib
import os

import jax

VERBOSE_ENV = "NEPTUNE_TPU_VERBOSE"


def verbose_default() -> bool:
    return os.environ.get(VERBOSE_ENV, "0") == "1"


def report_solve(kind: str, name: str, info) -> None:
    """Print one KSP/SNES-style convergence line from (possibly traced) code.

    Works under jit via jax.debug.print — the answer to the reference's
    host-side printf after KSPSolve.
    """
    jax.debug.print(
        "[neptune] {k} {n}: iters={i} resnorm={r:.3e} converged={c}",
        k=kind,
        n=name,
        i=info.iters,
        r=info.resnorm,
        c=info.converged,
    )


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile for the enclosed block.

    with neptune_tpu.utils.profiling.trace("/tmp/prof"):
        solver.step(u)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span inside a profile (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)
