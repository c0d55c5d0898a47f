"""Newton–Krylov nonlinear solver (JFNK) — the SNES replacement.

The reference hands nonlinear systems to PETSc SNES configured as
residual-only JFNK: SNESNEWTONLS with finite-difference matrix-free J·v
(`SNESSetUseMatrixFree(TRUE,TRUE)`, `NeptunePETScRuntime.cpp:449-451,
1450-1452`), calling the dlsym'd compiled residual once per function
evaluation (`NL<Rank,Caps>::FormFunction`, `:897-1426`).

Upgrade: J·v is the **exact** jacobian-vector product via
`jax.jvp` on the traced residual (no finite-difference noise), the inner
solve is our matrix-free GMRES, and an Armijo backtracking line search
replaces SNESNEWTONLS's cubic line search. States are pytrees, so
multi-field systems (the `test_swe_implicit.py` (h, q) tuple API) work
directly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.tree import taxpy, tdot, tnorm, tscale
from .krylov import gmres


class NewtonInfo(NamedTuple):
    iters: jnp.ndarray  # Newton iterations taken
    resnorm: jnp.ndarray  # final ||F(x)||
    converged: jnp.ndarray
    krylov_iters: jnp.ndarray  # total inner Krylov iterations


def newton_krylov(
    residual: Callable,
    x0,
    *,
    tol: float = 1e-8,
    atol: float = 1e-12,
    max_iters: int = 50,
    krylov_tol: float = 1e-6,
    krylov_iters: int = 200,
    restart: int = 30,
    M: Optional[Callable] = None,
    line_search: bool = True,
    max_backtracks: int = 25,
    max_step: Optional[float] = None,
    jac_mv: Optional[Callable] = None,
):
    """Solve F(x) = 0 by Newton's method with GMRES inner solves.

    residual: pytree -> pytree (same structure).
    Convergence: ||F(x)|| <= max(tol * ||F(x0)||, atol) — SNES-style rtol+atol.
    max_step caps ||dx|| per Newton iteration (PETSc -snes_linesearch_maxstep).
    jac_mv: optional user linearization `(x, v) -> J(x)·v` (the consumed
    `jacobian=` attr of solve_nonlinear); default is the exact jvp of
    `residual`. An approximate jac_mv yields inexact Newton — the line
    search still globalizes on the true residual.
    """
    F0 = residual(x0)
    f0norm = tnorm(F0)
    target = jnp.maximum(tol * f0norm, jnp.asarray(atol, f0norm.dtype))

    def cond(state):
        x, F, fnorm, k, kry, stall_count = state
        return jnp.logical_and(
            jnp.logical_and(k < max_iters, fnorm > target),
            stall_count < 2,  # two consecutive non-descent steps -> give up
        )

    def body(state):
        x, F, fnorm, k, kry, stall_count = state

        def jv(v):
            if jac_mv is not None:
                return jac_mv(x, v)
            return jax.jvp(residual, (x,), (v,))[1]

        # Solve J dx = -F  (matrix-free, exact J·v via jvp)
        rhs = tscale(-1.0, F)
        dx, info = gmres(
            jv,
            rhs,
            tol=krylov_tol,
            maxiter=krylov_iters,
            restart=restart,
            M=M,
        )
        if max_step is not None:
            dxnorm = tnorm(dx)
            cap = jnp.asarray(max_step, dxnorm.dtype)
            dx = tscale(
                jnp.where(dxnorm > cap, cap / jnp.maximum(dxnorm, 1e-30), 1.0),
                dx,
            )

        if line_search:
            # Armijo backtracking: accept the longest lambda with
            # ||F(x + lambda dx)|| <= (1 - 1e-4 * lambda) ||F(x)||;
            # if none passes, fall back to the lambda with smallest ||F||
            # (globalization — plain full steps blow up on stiff cubics).
            def bt_body(i, carry):
                lam, best_lam, accepted, min_fn, min_lam = carry
                trial = taxpy(lam, dx, x)
                fn = tnorm(residual(trial))
                ok = fn <= (1.0 - 1e-4 * lam) * fnorm
                take = jnp.logical_and(ok, jnp.logical_not(accepted))
                best_lam = jnp.where(take, lam, best_lam)
                accepted = jnp.logical_or(accepted, ok)
                better = fn < min_fn
                min_fn = jnp.where(better, fn, min_fn)
                min_lam = jnp.where(better, lam, min_lam)
                return lam * 0.5, best_lam, accepted, min_fn, min_lam

            one = jnp.asarray(1.0, fnorm.dtype)
            inf = jnp.asarray(jnp.inf, fnorm.dtype)
            _, lam, accepted, _, min_lam = jax.lax.fori_loop(
                0, max_backtracks, bt_body, (one, one, jnp.bool_(False), inf, one)
            )
            lam = jnp.where(accepted, lam, min_lam)
        else:
            lam = jnp.asarray(1.0, fnorm.dtype)

        x_new = taxpy(lam, dx, x)
        F_new = residual(x_new)
        fnorm_new = tnorm(F_new)
        # stagnation guard: count consecutive non-descent steps (avoids
        # burning max_iters * krylov_iters on a stuck iteration while still
        # permitting one uphill move of an inexact-Newton step)
        stall_count = jnp.where(fnorm_new >= fnorm, stall_count + 1, jnp.int32(0))
        return x_new, F_new, fnorm_new, k + 1, kry + info.iters, stall_count

    init = (x0, F0, f0norm, jnp.int32(0), jnp.int32(0), jnp.int32(0))
    x, F, fnorm, k, kry, _ = jax.lax.while_loop(cond, body, init)
    return x, NewtonInfo(k, fnorm, fnorm <= target, kry)


def picard(
    residual: Callable,
    x0,
    *,
    tol: float = 1e-8,
    max_iters: int = 200,
    damping: float = 1.0,
):
    """Damped Picard / Richardson iteration for F(x) = 0: x <- x - w F(x).

    Takes the same residual as newton_krylov (the `solve_nonlinear` contract,
    NeptuneIROps.td:697-736), converging when I - w dF/dx is a contraction.
    Convergence test: ||F(x)|| <= tol.
    """

    def cond(state):
        x, F, fnorm, k = state
        return jnp.logical_and(k < max_iters, fnorm > tol)

    def body(state):
        x, F, _, k = state
        x_new = taxpy(-damping, F, x)
        F_new = residual(x_new)
        return x_new, F_new, tnorm(F_new), k + 1

    F0 = residual(x0)
    x, F, fnorm, k = jax.lax.while_loop(
        cond, body, (x0, F0, tnorm(F0), jnp.int32(0))
    )
    return x, NewtonInfo(k, fnorm, fnorm <= tol, jnp.int32(0))
