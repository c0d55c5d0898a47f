"""Matrix-free Krylov solvers: CG, BiCGStab, restarted GMRES.

Replacement for the reference's PETSc KSP runtime
(`lib/Runtime/PETSc/NeptunePETScRuntime.cpp:112-419`): where PETSc wraps the
compiled stencil kernel in a MatShell and calls it back through dlsym per
iteration (`:182-230`), here the operator is a traced JAX callable closed over
at compile time, so every Krylov iteration fuses into one XLA computation and
runs fully on-device under `lax.while_loop` (no host round-trips per
iteration, unlike the reference's per-iteration printf path `:338-359`).

Solver selection mirrors the reference's `solve_linear` attrs
("cg"/"gmres"/"bicgstab", `include/Dialect/NeptuneIR/NeptuneIROps.td:646-684`)
with PETSc-style defaults (GMRES + no preconditioner,
`NeptunePETScRuntime.cpp:146-149`).

All solvers:
  * operate on arbitrary pytree states (grids, multi-field tuples);
  * use relative tolerance ||r|| <= max(tol * ||b||, atol) like PETSc's default
    rtol convergence test;
  * run a fixed-structure `lax.while_loop` so they are jittable, differentiable
    via custom solves later, and shard_map-transparent (all reductions go
    through tdot -> psum when sharded);
  * return (x, SolveInfo) with iteration count, residual norm, and a
    convergence flag (the data the reference prints after each KSPSolve,
    `NeptunePETScRuntime.cpp:345-359`).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.tree import ravel, taxpy, tdot, tnorm, tscale, tsub, tzeros_like


class SolveInfo(NamedTuple):
    iters: jnp.ndarray  # int32 iteration count
    resnorm: jnp.ndarray  # final residual norm
    converged: jnp.ndarray  # bool


def _tolerances(b, tol, atol):
    bnorm = tnorm(b)
    # Guard ||b|| = 0: converge to x = 0 via the atol floor.
    return jnp.maximum(tol * bnorm, jnp.asarray(atol, bnorm.dtype)), bnorm


def _divergence_bound(bnorm, divtol):
    """||r|| above this is divergence (PETSc -ksp_divtol, relative to ||b||;
    default off — the reference's default is 1e5 but PETSc only applies it
    after the first iteration, and transient residual spikes are normal in
    BiCGStab, so divergence detection is opt-in via options={'divtol': ...})."""
    big = jnp.asarray(jnp.finfo(bnorm.dtype).max, bnorm.dtype)
    if divtol is None:
        return big
    return jnp.minimum(divtol * jnp.maximum(bnorm, 1.0), big)


def _identity(x):
    return x


# ---------------------------------------------------------------------------
# Conjugate Gradient (preconditioned)
# ---------------------------------------------------------------------------


def cg(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    divtol: Optional[float] = None,
):
    """Preconditioned conjugate gradient for SPD operators."""
    M = M or _identity
    x0 = tzeros_like(b) if x0 is None else x0
    target, bnorm = _tolerances(b, tol, atol)
    divbound = _divergence_bound(bnorm, divtol)

    r0 = tsub(b, matvec(x0))
    z0 = M(r0)
    p0 = z0
    rz0 = tdot(r0, z0)

    def cond(state):
        x, r, z, p, rz, k, rnorm = state
        return jnp.logical_and(
            jnp.logical_and(k < maxiter, rnorm > target), rnorm <= divbound
        )

    def body(state):
        x, r, z, p, rz, k, _ = state
        Ap = matvec(p)
        pAp = tdot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, Ap, r)
        z = M(r)
        rz_new = tdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = taxpy(beta, p, z)
        return x, r, z, p, rz_new, k + 1, tnorm(r)

    init = (x0, r0, z0, p0, rz0, jnp.int32(0), tnorm(r0))
    x, r, z, p, rz, k, rnorm = jax.lax.while_loop(cond, body, init)
    return x, SolveInfo(k, rnorm, rnorm <= target)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def bicgstab(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    divtol: Optional[float] = None,
):
    """Preconditioned BiCGStab for general (non-symmetric) operators."""
    M = M or _identity
    x0 = tzeros_like(b) if x0 is None else x0
    target, bnorm = _tolerances(b, tol, atol)
    divbound = _divergence_bound(bnorm, divtol)

    r0 = tsub(b, matvec(x0))
    rhat = r0  # shadow residual

    def cond(state):
        x, r, p, v, rho, alpha, omega, k, rnorm = state
        return jnp.logical_and(
            jnp.logical_and(k < maxiter, rnorm > target), rnorm <= divbound
        )

    def body(state):
        x, r, p, v, rho, alpha, omega, k, _ = state
        rho_new = tdot(rhat, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
            alpha / jnp.where(omega == 0, 1.0, omega)
        )
        p = taxpy(beta, tsub(p, tscale(omega, v)), r)
        phat = M(p)
        v = matvec(phat)
        denom = tdot(rhat, v)
        alpha = rho_new / jnp.where(denom == 0, 1.0, denom)
        s = taxpy(-alpha, v, r)
        shat = M(s)
        t = matvec(shat)
        tt = tdot(t, t)
        omega = tdot(t, s) / jnp.where(tt == 0, 1.0, tt)
        x = taxpy(alpha, phat, taxpy(omega, shat, x))
        r = taxpy(-omega, t, s)
        return x, r, p, v, rho_new, alpha, omega, k + 1, tnorm(r)

    one = jnp.asarray(1.0, tnorm(b).dtype)
    init = (
        x0,
        r0,
        tzeros_like(b),
        tzeros_like(b),
        one,
        one,
        one,
        jnp.int32(0),
        tnorm(r0),
    )
    x, r, p, v, rho, alpha, omega, k, rnorm = jax.lax.while_loop(cond, body, init)
    return x, SolveInfo(k, rnorm, rnorm <= target)


# ---------------------------------------------------------------------------
# Restarted GMRES (modified Gram-Schmidt + Givens rotations)
# ---------------------------------------------------------------------------


def gmres(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    restart: int = 30,
    M: Optional[Callable] = None,
    divtol: Optional[float] = None,
):
    """Restarted GMRES(m). Matches PETSc's default KSP (GMRES(30) + PCNONE,
    `NeptunePETScRuntime.cpp:146-149`). Left preconditioning with M."""
    M = M or _identity
    x0 = tzeros_like(b) if x0 is None else x0
    flat_b, unravel = ravel(b)
    n = flat_b.shape[0]
    dtype = flat_b.dtype
    m = int(min(restart, maxiter, n))

    def flat_matvec(v):
        return ravel(matvec(unravel(v)))[0]

    def flat_M(v):
        return ravel(M(unravel(v)))[0]

    Mb = flat_M(flat_b)
    Mbnorm = jnp.linalg.norm(Mb)
    target = jnp.maximum(tol * Mbnorm, jnp.asarray(atol, dtype))
    divbound = _divergence_bound(Mbnorm, divtol)

    x0f = ravel(x0)[0]

    def outer_cond(state):
        x, k, rnorm, converged = state
        return jnp.logical_and(
            jnp.logical_and(k < maxiter, jnp.logical_not(converged)),
            rnorm <= divbound,
        )

    def outer_body(state):
        x, k, rnorm0, _ = state
        r = flat_M(flat_b - flat_matvec(x))
        beta = jnp.linalg.norm(r)

        V = jnp.zeros((m + 1, n), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        V = V.at[0].set(r / jnp.where(beta == 0, 1.0, beta))

        def arnoldi_step(j, carry):
            V, H, cs, sn, g, resnorm, done, niters = carry
            active = jnp.logical_not(done)

            # skip the (dominant-cost) operator+preconditioner application on
            # steps after convergence was reached within this restart cycle
            w = jax.lax.cond(
                done,
                lambda: jnp.zeros((n,), dtype),
                lambda: flat_M(flat_matvec(V[j])),
            )
            # modified Gram-Schmidt against V[0..j]
            def mgs(i, wh):
                w, h = wh
                hij = jnp.where(i <= j, jnp.vdot(V[i], w), 0.0)
                w = w - hij * V[i]
                return w, h.at[i].set(hij)

            w, hcol = jax.lax.fori_loop(
                0, m + 1, mgs, (w, jnp.zeros((m + 1,), dtype))
            )
            hjp1 = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hjp1)
            V = jnp.where(active, V.at[j + 1].set(w / jnp.where(hjp1 == 0, 1.0, hjp1)), V)

            # apply existing Givens rotations to the new column
            def apply_rot(i, h):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hip1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                h = h.at[i].set(jnp.where(i < j, hi, h[i]))
                return h.at[i + 1].set(jnp.where(i < j, hip1, h[i + 1]))

            hcol = jax.lax.fori_loop(0, m, apply_rot, hcol)

            # new rotation annihilating hcol[j+1]
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            denom_safe = jnp.where(denom == 0, 1.0, denom)
            c_new = jnp.where(denom == 0, 1.0, hcol[j] / denom_safe)
            s_new = jnp.where(denom == 0, 0.0, hcol[j + 1] / denom_safe)
            hcol = hcol.at[j].set(c_new * hcol[j] + s_new * hcol[j + 1])
            hcol = hcol.at[j + 1].set(0.0)

            g_j = c_new * g[j]
            g_jp1 = -s_new * g[j]

            new_resnorm = jnp.abs(g_jp1)
            H = jnp.where(active, H.at[:, j].set(hcol[: m + 1]), H)
            cs = jnp.where(active, cs.at[j].set(c_new), cs)
            sn = jnp.where(active, sn.at[j].set(s_new), sn)
            g = jnp.where(active, g.at[j].set(g_j).at[j + 1].set(g_jp1), g)
            resnorm = jnp.where(active, new_resnorm, resnorm)
            niters = jnp.where(active, niters + 1, niters)
            # stop mid-cycle once the TOTAL iteration budget is spent:
            # restarted GMRES would otherwise overrun maxiter by up to
            # restart-1 matvecs (PETSc stops at max_iters exactly, and
            # maxiter is used as a hard cost budget by newton_krylov's
            # inner solves)
            done = jnp.logical_or(
                jnp.logical_or(done, resnorm <= target),
                k + niters >= maxiter,
            )
            return V, H, cs, sn, g, resnorm, done, niters

        carry = (V, H, cs, sn, g, beta, beta <= target, jnp.int32(0))
        V, H, cs, sn, g, resnorm, done, niters = jax.lax.fori_loop(
            0, m, arnoldi_step, carry
        )

        # back-substitution on the j_used x j_used triangular system (masked)
        j_used = niters  # number of Arnoldi steps actually performed

        def back_sub(idx, y):
            i = m - 1 - idx

            def active_case(y):
                dot = jnp.dot(H[i, :], y, precision="highest")
                Hii = H[i, i]
                yi = (g[i] - dot) / jnp.where(Hii == 0, 1.0, Hii)
                return y.at[i].set(yi)

            return jax.lax.cond(i < j_used, active_case, lambda y: y, y)

        y = jax.lax.fori_loop(0, m, back_sub, jnp.zeros((m,), dtype))
        dx = jnp.dot(y, V[:m], precision="highest")
        x = x + dx
        return x, k + niters, resnorm, resnorm <= target

    rnorm_init = jnp.linalg.norm(flat_M(flat_b - flat_matvec(x0f)))
    init = (x0f, jnp.int32(0), rnorm_init, rnorm_init <= target)
    x, k, rnorm, converged = jax.lax.while_loop(outer_cond, outer_body, init)
    return unravel(x), SolveInfo(k, rnorm, converged)


# ---------------------------------------------------------------------------
# Direct dense solve (small systems / tests)
# ---------------------------------------------------------------------------


def direct(matvec_dense_matrix, b, **_kw):
    """LU solve against an assembled dense matrix. The analog of the
    reference's DenseRM KSP path (`NeptunePETScRuntime.cpp:241-252,301-364`)."""
    flat_b, unravel = ravel(b)
    x = jnp.linalg.solve(matvec_dense_matrix, flat_b)
    r = jnp.matmul(matvec_dense_matrix, x, precision="highest") - flat_b
    rnorm = jnp.linalg.norm(r)
    return unravel(x), SolveInfo(jnp.int32(1), rnorm, jnp.bool_(True))


SOLVERS = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}


def solve(
    matvec: Callable,
    b,
    solver: str = "gmres",
    **kwargs,
):
    """Dispatch by solver name (the reference's solver attr dispatch,
    `RuntimeLowering.cpp:185-215`)."""
    try:
        fn = SOLVERS[solver]
    except KeyError:
        raise ValueError(f"unknown linear solver {solver!r}; options: {sorted(SOLVERS)}")
    return fn(matvec, b, **kwargs)
