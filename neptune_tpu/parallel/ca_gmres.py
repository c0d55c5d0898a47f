"""Communication-avoiding (s-step) restarted GMRES on sharded fields.

GMRES(30) is the reference's *default* KSP
(`/root/reference/lib/Runtime/PETSc/NeptunePETScRuntime.cpp:146-149`). Its
distributed cost per iteration is one halo exchange (the matvec) plus O(j)
dot-product psums (modified Gram–Schmidt against the growing basis) — the
worst collective profile of all the Krylov methods. This module runs
restarted GMRES(s) in s-step form: per restart cycle, ONE (s+1)-deep strip
exchange builds the s+1-vector Krylov basis with the matrix-powers kernel
(zero-ghost chains + trapezoid band replay — the shared machinery of
`shardmap_sweeps` / `ca_chebyshev` / `ca_cg`), ONE psum reduces the
(s+1)² Gram matrix, and the least-squares problem

    min_y || r0 - Ã (V[:, :s] y) ||_2

is then solved entirely in replicated coefficient space: with the
change-of-basis B (Ã V_j = Σ_i B[i,j] V_i), the residual in basis
coordinates is c(y) = e0 - B[:, :s] y and ||V c||² = cᵀ G c, so a Cholesky
factor G = LLᵀ turns the problem into an ordinary (s+1)×s dense LS
min ||Lᵀc(y)|| (Gram-based QR — the CA-GMRES construction of Mohiyuddin,
Hoemmen, Demmel & Yelick, with the Gram matrix standing in for TSQR; the
basis conditioning enters squared, which the Chebyshev basis option keeps
in check at larger s).

Numerics:
  * Restart-cycle residual replacement for free: every cycle re-seeds the
    chain from the TRUE residual r0 = b̃ - Ã x recomputed inside the
    matrix-powers kernel (x rides the strip exchange), so coefficient-space
    drift cannot accumulate across cycles — restarted GMRES's natural
    structure IS the s-step stability fix.
  * Jacobi preconditioning as a split similarity transform Ã = S A S with
    S = sqrt(inv_diag) (pointwise; requires a positive diagonal). The
    minimized norm is ||S(b - A x)||, i.e. split-preconditioned GMRES —
    equivalent to the `solvers.gmres` oracle run on the transformed
    operator, not to left-preconditioned GMRES (different norm).
  * basis="monomial" (fine for s ≲ 6) or "chebyshev" (needs lam_min /
    lam_max bounding the spectrum's real part; keeps κ(V) — and hence
    κ(G) = κ(V)² — bounded at larger s).

Communication per s iterations: one exchange of (s+1)·reach-deep strips of
ONE field (x) + one (s+1)² psum, versus s exchanges + O(s²/2) dot psums for
per-iteration MGS-GMRES. Matvec count is s+1 per cycle (the extra one
computes the true-residual seed) — same count as standard restarted GMRES,
which also spends one matvec per cycle re-seeding.

`maxiter` rounds up to a multiple of s (convergence is tested per cycle,
like PETSc's per-restart norm checks at KSP_NORM_NONE granularity).

No reference counterpart for the distributed form (the reference is
single-process, SURVEY.md §2.8).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import jax.numpy as jnp
from jax import lax

from .ca_cg import _basis_matrix
from jax.scipy.linalg import solve_triangular as jsp_solve_triangular

from .ca_common import MatrixPowers, _mm, plan_ca_solver, run_ca_solver
from .mesh import GridMesh


def gmres_sharded(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    s: int = 6,
    maxiter: int = 200,
    tol: float = 1e-6,
    inv_diag=None,
    basis: str = "monomial",
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
) -> Callable:
    """Build a jittable communication-avoiding restarted GMRES(s) solve for
    A = @name (any invertible operator — symmetry NOT required).

    Returns solve(b) -> (x, SolveInfo). inv_diag, if given, is the Jacobi
    preconditioner diagonal (positive, full-field, sharded like b).
    basis="chebyshev" requires lam_min/lam_max bounding the (real part of
    the) spectrum of Ã = S A S."""
    # the chain applies Ã s+1 times from x (1 for the true-residual seed,
    # s for the basis), so the strips must carry (s+1)-deep reach
    sp = plan_ca_solver(
        cm, name, gmesh, s=s, kdepth=s + 1, kdepth_desc="(s+1)",
        solver="gmres_sharded", basis=basis, lam_min=lam_min,
        lam_max=lam_max,
    )
    # Monomial small-s guard: short-restart monomial CA-GMRES in f32 is
    # sensitive to the Gram pipeline's rounding and can stagnate. The stall
    # detector then exits with converged=False after two flat cycles, but
    # nothing says WHY, so the config is warned about up front. Silence it
    # with NEPTUNE_ALLOW_MONOMIAL_SMALL_S=1.
    if (
        basis == "monomial"
        and s <= 4
        and sp.dtype == jnp.float32
        and not os.environ.get("NEPTUNE_ALLOW_MONOMIAL_SMALL_S")
    ):
        warnings.warn(
            f"gmres_sharded(basis='monomial', s={s}) can stall in f32 "
            "arithmetic. Use basis='chebyshev' (with lam_min/lam_max), "
            "raise s to >= 6, or set NEPTUNE_ALLOW_MONOMIAL_SMALL_S=1 to "
            "silence this warning.",
            stacklevel=2,
        )
    rank, names, need, spec = sp.rank, sp.names, sp.need, sp.spec
    outer, dtype, periodic = sp.outer, sp.dtype, sp.periodic
    theta, delta, matvec_block = sp.theta, sp.delta, sp.matvec_block

    m = s + 1
    Bred = _basis_matrix((m,), basis, theta, delta, dtype)[:, :s]  # m x s

    def global_fn(b):
        def local_fn(bl, sl):
            # shared matrix-powers machinery (one exchange per cycle, core
            # chain + trapezoid band replays, honest final matvec)
            mp = MatrixPowers(
                matvec_block=matvec_block, names=names, rank=rank,
                outer=outer, dtype=dtype, periodic=periodic, basis=basis,
                theta=theta, delta=delta,
                need_k=[((s + 1) * lo, (s + 1) * hi) for lo, hi in need],
                need_1=need,
                bl=bl, sl=sl,
            )
            nloc, gsum = mp.nloc, mp.gsum

            b2 = gsum(jnp.sum(mp.btl * mp.btl))
            target2 = jnp.asarray(tol * tol, dtype) * b2

            def outer_body(carry):
                x, rr_prev, it, done, stall, best_x, best_rr = carry
                # ---- one exchange: (s+1)-deep strips of x; basis =
                # [r, Ãr, .., Ã^s r], r = b̃ - Ã x (the TRUE residual) ----
                V = mp.basis_with_replay([x], (s + 1,))

                # ---- one psum: the Gram matrix ----
                Vs = jnp.stack([v.reshape(-1) for v in V])
                G = gsum(_mm(Vs, Vs.T))

                # Convergence is decided on the CYCLE SEED norm ||r0||² =
                # G[0,0] — a direct sum of squares of the true residual
                # field. The LS objective value c·G·c is a coefficient-
                # space quadratic form that bottoms out at ~sqrt(eps)·||b̃||²
                # (and can round to 0 well before tol is truly met), so it
                # is NOT used for control: each cycle's update lands, and
                # the next cycle's seed measures what it actually achieved.
                rr_seed = G[0, 0]
                # best-iterate tracking on the trusted seed (same safety
                # net as ca_cg): the returned x is never worse than the
                # best cycle start even if late cycles wander
                improved = rr_seed < best_rr
                best_x = jnp.where(improved, x, best_x)
                best_rr = jnp.where(improved, rr_seed, best_rr)
                done_now = rr_seed <= target2

                # Column normalization (zero extra communication, same
                # trick as ca_bicgstab): basis norms grow like lam^j for
                # the monomial basis, so the raw Gram's condition is
                # kappa(V)^2 * (norm spread)^2 and its small eigenvalues
                # drown in f32 noise. Work in V' = V·diag(1/||V_j||)
                # (norms from the Gram diagonal): G' = D G D,
                # B'[i,j] = B[i,j]·d_i/d_j, seed e0' = d_0·e0, and
                # recover y = y'/||V_j||.
                dG = jnp.sqrt(jnp.clip(jnp.diag(G), 0.0, None))
                dsafe = jnp.where(dG > 0, dG, jnp.asarray(1.0, dtype))
                Gs = G / (dsafe[:, None] * dsafe[None, :])
                Bs = Bred * (dsafe[:, None] / dsafe[None, :s])

                # ---- replicated LS: min_y' (e0' - B' y')ᵀ G' (e0' - B' y')
                # via G' = L̃L̃ᵀ from the clamped eigendecomposition (a
                # Cholesky NaNs out when the basis degenerates to near
                # rank-1 — e.g. a near-identity operator — eigh is
                # NaN-free). The LS itself solves through Householder QR
                # + one step of iterative refinement, NOT lstsq: an f32
                # SVD can return much noisier components in the small-
                # singular directions than QR, and that noise enters y
                # every cycle and stalls the solve orders above tol.
                # Rank deficiency is handled by masking
                # columns whose R diagonal underflows the dtype's
                # rank tolerance (the trailing basis directions), which
                # keeps the solve NaN-free where lstsq returned the
                # min-norm y. ----
                w_ev, Q_ev = jnp.linalg.eigh(Gs)
                if basis == "chebyshev":
                    # The Chebyshev basis is well-conditioned BY DESIGN, so
                    # normalized-Gram eigenvalues below the f32 dot-product
                    # noise floor (~sqrt(N)·eps relative) are pure noise;
                    # keeping them injects that noise into x every cycle
                    # and multiplies the iteration count. The monomial basis
                    # is ill-conditioned by construction — its small
                    # eigenvalues CARRY the trailing Krylov directions, and
                    # clamping them stalls the solve — so it keeps the full
                    # spectrum and relies on the QR solve's accuracy.
                    tau = 2500.0 * jnp.finfo(dtype).eps * jnp.max(w_ev)
                    w_ev = jnp.where(w_ev > tau, w_ev, 0.0)
                Lt = jnp.sqrt(jnp.maximum(w_ev, 0.0))[:, None] * Q_ev.T
                A_ls = _mm(Lt, Bs)  # m×s
                b_ls = Lt[:, 0] * dsafe[0]  # = L̃ᵀ e0'
                Q_ls, R_ls = jnp.linalg.qr(A_ls)
                rdiag = jnp.abs(jnp.diag(R_ls))
                keep = rdiag > (
                    jnp.finfo(dtype).eps * s * jnp.max(rdiag)
                )
                # dropped columns must be zeroed whole (not just the diagonal):
                # their off-diagonal entries would otherwise fold garbage
                # y_j into every kept component during back-substitution
                R_safe = jnp.where(keep[None, :], R_ls, 0.0) + jnp.diag(
                    jnp.where(keep, 0.0, jnp.asarray(1.0, dtype))
                )

                def tri_solve(rhs):
                    yk = jsp_solve_triangular(
                        R_safe, _mm(Q_ls.T, rhs)
                    )
                    return jnp.where(keep, yk, 0.0)

                y = tri_solve(b_ls)
                y = y + tri_solve(b_ls - _mm(A_ls, y))
                y = jnp.where(done_now, jnp.zeros_like(y), y)

                # ---- recover x (local, no comm): y = y'/||V_j|| ----
                x = x + jnp.tensordot(
                    y / dsafe[:s], jnp.stack(V[:s]), axes=1,
                    precision="highest",
                )
                # two consecutive cycles with no seed reduction = stagnated
                stall = jnp.where(
                    jnp.logical_not(done_now) & (rr_seed >= rr_prev),
                    stall + 1,
                    jnp.int32(0),
                )
                it = it + jnp.where(done_now, 0, s)
                return x, rr_seed, it, done_now, stall, best_x, best_rr

            def cond(carry):
                _x, _rr, it, done, stall = carry[:5]
                return jnp.logical_not(done) & (it < maxiter) & (stall < 2)

            x0 = jnp.zeros(nloc, dtype)
            x, rr, it, done, _stall, best_x, best_rr = lax.while_loop(
                cond, outer_body,
                (x0, b2 + 1.0, jnp.int32(0), jnp.asarray(False),
                 jnp.int32(0), x0, jnp.asarray(jnp.inf, dtype)),
            )

            # ---- honest final report: when the loop exited mid-cycle
            # (maxiter/stall), rr is the seed of the PREVIOUS x; one extra
            # exchanged matvec reports the returned x's true residual.
            # Safety net: fall back to the best seeded iterate only when
            # the final x is pathologically worse (>100x) than it ----
            rr = jnp.where(done, rr, mp.true_rr(x))
            take_cur = rr <= 100.0 * best_rr
            x = jnp.where(take_cur, x, best_x)
            rr = jnp.where(take_cur, rr, best_rr)
            # un-transform: x = S y
            if mp.S_loc is not None:
                x = mp.S_loc * x
            return x, rr, it, target2

        return run_ca_solver(local_fn, gmesh, spec, b, inv_diag)

    return global_fn
