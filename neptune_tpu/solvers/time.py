"""Whole-simulation time loops under one jit.

The reference steps time from Python, paying a ctypes call + PETSc setup per
step (`jit.py:128-149` dispatch loop). Here: roll the step
function into `lax.scan` so an entire N-step simulation (each step possibly
containing a full Krylov/Newton solve) is ONE XLA executable — no host
round-trips, and XLA pipelines/fuses across steps where legal.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp


def simulate(
    step: Callable,
    state0,
    n_steps: int,
    *,
    record_every: Optional[int] = None,
    jit: bool = True,
    differentiable: bool = False,
):
    """Run `state = step(state)` n_steps times on-device.

    record_every=k additionally returns the state every k steps, stacked on a
    leading axis (for trajectories/visualization). The state may be any
    pytree (multi-field systems).

    differentiable=True builds the loop with `lax.scan` so reverse-mode AD
    works through the whole simulation (adjoint time integration; XLA
    checkpoints per-step residuals — combine with jax.checkpoint on `step`
    for long horizons). The default `fori_loop` form is cheaper to compile
    but not reverse-differentiable.
    """

    if record_every is None:

        if differentiable:

            def run(s0):
                def body(s, _):
                    return step(s), None

                final, _ = jax.lax.scan(body, s0, None, length=n_steps)
                return final

        else:

            def run(s0):
                return jax.lax.fori_loop(0, n_steps, lambda i, s: step(s), s0)

    else:
        outer = n_steps // record_every
        remainder = n_steps - outer * record_every

        def run(s0):
            def body(s, _):
                s = jax.lax.fori_loop(0, record_every, lambda i, x: step(x), s)
                return s, s

            final, traj = jax.lax.scan(body, s0, None, length=outer)
            if remainder:
                # run the tail steps so exactly n_steps execute (the trailing
                # partial chunk is not recorded in traj)
                final = jax.lax.fori_loop(
                    0, remainder, lambda i, x: step(x), final
                )
            return final, traj

    return jax.jit(run)(state0) if jit else run(state0)
