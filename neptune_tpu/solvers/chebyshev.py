"""Chebyshev iteration — the reduction-free solver/smoother for device meshes.

No reference counterpart (PETSc exposes `-ksp_type chebyshev` but the
reference's DSL surfaces only cg/gmres/bicgstab,
`include/Dialect/NeptuneIR/NeptuneIROps.td:646-684`). It earns its place in
this build: every CG/GMRES iteration needs inner products, which on a
sharded mesh become `psum` all-reduces — a per-iteration latency floor.
Chebyshev's recurrence needs NO inner products: each iteration is one
matvec (stencil + halo exchange) plus axpys, so a sharded solve runs with
zero global collectives in the loop (`check_every=0` does a single residual
reduction at the very end). The price is needing spectrum bounds
[lam_min, lam_max] of the (preconditioned) SPD operator, estimated here by
one-time power iterations when not supplied.

Also the natural multigrid smoother on a mesh (`multigrid_solve(...,
smoother="cheb")` territory): fixed-k Chebyshev smoothing targets the upper
part of the spectrum [lam_max/alpha, lam_max] without any reductions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.tree import taxpy, tnorm, tscale, tsub, tzeros_like
from .krylov import SolveInfo, _identity, _tolerances


class SpectrumBounds(NamedTuple):
    lam_min: jnp.ndarray
    lam_max: jnp.ndarray


def power_method(matvec: Callable, probe, iters: int = 40, M: Optional[Callable] = None):
    """Largest-eigenvalue estimate of (M o matvec) by power iteration.

    `probe` seeds the iteration (any vector with a component along the top
    eigenvector; the right-hand side works). Runs on-device in a fori_loop —
    jittable and shard_map-transparent (norms psum when sharded)."""
    M = M or _identity

    def body(_, v):
        w = M(matvec(v))
        return tscale(1.0 / jnp.maximum(tnorm(w), 1e-300), w)

    v = tscale(1.0 / jnp.maximum(tnorm(probe), 1e-300), probe)
    v = jax.lax.fori_loop(0, iters, body, v)
    w = M(matvec(v))
    return tnorm(w)  # ||v|| == 1


def estimate_spectrum(
    matvec: Callable,
    probe,
    iters: int = 40,
    M: Optional[Callable] = None,
    safety: float = 1.05,
):
    """[lam_min, lam_max] bounds for an SPD (preconditioned) operator.

    lam_max by power iteration (inflated by `safety`); lam_min by power
    iteration on the spectrum-reflected operator lam_max*I - A, which maps
    the smallest eigenvalue to the largest. Both are one-time costs outside
    the solve loop (2*iters matvecs)."""
    M = M or _identity
    lam_max = power_method(matvec, probe, iters, M) * safety

    def reflected(v):
        return tsub(tscale(lam_max, v), M(matvec(v)))

    lam_min = lam_max - power_method(reflected, probe, iters)
    # clamp away from 0 (a singular/near-null mode would zero the interval)
    lam_min = jnp.maximum(lam_min, lam_max * 1e-8)
    return SpectrumBounds(lam_min, lam_max)


def chebyshev(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
    check_every: int = 0,
    spectrum_iters: int = 40,
    residual_replacement: bool = True,
    replace_every: int = 0,
):
    """Preconditioned Chebyshev iteration for SPD operators.

    check_every=0 (default): a reduction-FREE loop — run exactly `maxiter`
    iterations and measure the residual once at the end. On a device mesh
    this keeps the entire solve free of global collectives (only the
    stencil's halo ppermutes run per iteration).
    check_every=k: test ||r|| <= max(tol*||b||, atol) every k iterations
    (one psum-able reduction per k matvecs) and stop early.

    Residual replacement (automatic): the recurrence residual drifts from
    the true b - A·x by ~1e-5 relative over thousands of f32 iterations
    (standard long-recurrence behavior). With residual_replacement=True
    every check_every boundary recomputes the TRUE residual (one extra
    matvec per k iterations) and restarts the recurrence from it, so both
    the convergence test and the returned resnorm are drift-free. In the
    reduction-free path set replace_every=m to rebase every m iterations
    without adding any reduction (the extra matvec stays collective-free).

    Missing spectrum bounds are estimated by `estimate_spectrum` (one-time
    power iterations, jittable)."""
    M = M or _identity
    x0 = tzeros_like(b) if x0 is None else x0

    if lam_max is None or lam_min is None:
        est = estimate_spectrum(matvec, b, spectrum_iters, M)
        lam_min = est.lam_min if lam_min is None else lam_min
        lam_max = est.lam_max if lam_max is None else lam_max

    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta

    target, _bnorm = _tolerances(b, tol, atol)

    r0 = tsub(b, matvec(x0))
    z0 = M(r0)
    d0 = tscale(1.0 / theta, z0)
    x1 = taxpy(1.0, d0, x0)
    r1 = tsub(r0, matvec(d0))
    rho0 = 1.0 / sigma1

    def one_iter(x, r, d, rho_prev):
        z = M(r)
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        d = taxpy(2.0 * rho / delta, z, tscale(rho * rho_prev, d))
        x = taxpy(1.0, d, x)
        r = tsub(r, matvec(d))
        return x, r, d, rho

    if check_every <= 0:
        # reduction-free: fixed iteration count in a fori_loop
        def body(i, carry):
            x, r, d, rho = one_iter(*carry)
            if replace_every > 0:
                r = jax.lax.cond(
                    (i + 2) % replace_every == 0,  # i=0 is global iter 2
                    lambda: tsub(b, matvec(x)),
                    lambda: r,
                )
            return x, r, d, rho

        x, r, d, rho = jax.lax.fori_loop(
            0, maxiter - 1, body, (x1, r1, d0, rho0)
        )
        rnorm = tnorm(tsub(b, matvec(x))) if residual_replacement else tnorm(r)
        return x, SolveInfo(jnp.int32(maxiter), rnorm, rnorm <= target)

    def cond(state):
        x, r, d, rho, k, rnorm = state
        return jnp.logical_and(k < maxiter, rnorm > target)

    def body(state):
        x, r, d, rho, k, rnorm = state

        def chunk(_, carry):
            return one_iter(*carry)

        x, r, d, rho = jax.lax.fori_loop(0, check_every, chunk, (x, r, d, rho))
        if residual_replacement:
            # rebase the recurrence on the TRUE residual at the check point:
            # the test and the recurrence both proceed drift-free
            r = tsub(b, matvec(x))
        return x, r, d, rho, k + check_every, tnorm(r)

    init = (x1, r1, d0, rho0, jnp.int32(1), tnorm(r1))
    x, r, d, rho, k, rnorm = jax.lax.while_loop(cond, body, init)
    return x, SolveInfo(k, rnorm, rnorm <= target)


# register with the name dispatch (the reference's solver-attr dispatch,
# RuntimeLowering.cpp:185-215); done here to avoid a krylov<->chebyshev cycle
from .krylov import SOLVERS as _SOLVERS

_SOLVERS["chebyshev"] = chebyshev
