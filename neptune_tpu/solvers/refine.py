"""Mixed-precision iterative refinement — f64 accuracy at f32 compute rates.

f64 is slower than f32 on most accelerators (SURVEY.md §7 hard part (e)).
Classic iterative refinement sidesteps it: run the Krylov solve in
float32 against the float32 twin of the operator (passes.retype), evaluate
residuals and accumulate the solution in float64, repeat until the f64
residual meets tolerance. Each refinement round recovers ~6-7 digits, so 2-3
rounds reach 1e-12 while nearly all FLOPs run at f32 speed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.tree import tnorm, tsub
from . import krylov


class RefineInfo(NamedTuple):
    rounds: jnp.ndarray
    inner_iters: jnp.ndarray
    resnorm: jnp.ndarray
    converged: jnp.ndarray


def refined_solve(
    matvec_hi: Callable,
    matvec_lo: Callable,
    b,
    *,
    solver: str = "cg",
    tol: float = 1e-12,
    inner_tol: float = 1e-5,
    inner_iters: int = 500,
    max_rounds: int = 6,
    M_lo: Optional[Callable] = None,
):
    """Solve A x = b to f64 tolerance using f32 inner Krylov solves.

    matvec_hi: float64 operator (residual evaluation)
    matvec_lo: float32 twin (inner solves)
    """
    b = jnp.asarray(b, jnp.float64)
    bnorm = tnorm(b)
    target = tol * jnp.where(bnorm == 0, 1.0, bnorm)

    def cond(state):
        x, r, rnorm, k, inner = state
        return jnp.logical_and(k < max_rounds, rnorm > target)

    def body(state):
        x, r, _, k, inner = state
        r32 = jnp.asarray(r, jnp.float32)
        dx32, info = krylov.solve(
            matvec_lo,
            r32,
            solver=solver,
            tol=inner_tol,
            maxiter=inner_iters,
            M=M_lo,
        )
        x = x + jnp.asarray(dx32, jnp.float64)
        r = b - matvec_hi(x)
        return x, r, tnorm(r), k + 1, inner + info.iters

    x0 = jnp.zeros_like(b)
    r0 = b
    state = (x0, r0, tnorm(r0), jnp.int32(0), jnp.int32(0))
    x, r, rnorm, k, inner = jax.lax.while_loop(cond, body, state)
    return x, RefineInfo(k, inner, rnorm, rnorm <= target)
