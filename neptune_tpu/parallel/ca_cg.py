"""Communication-avoiding (s-step) conjugate gradient on sharded fields.

The reference's workhorse KSP solvers are CG/GMRES
(`/root/reference/lib/Runtime/PETSc/NeptunePETScRuntime.cpp:146-149`); their
distributed cost on a device mesh is dominated by per-iteration collectives —
two psums (dot products) and one halo exchange per CG iteration. This module
runs CG in s-step form: per outer step, ONE K-deep strip exchange builds the
2s+1-vector Krylov basis with the matrix-powers kernel (zero-ghost chains +
trapezoid band replay, the same machinery as `ca_chebyshev` /
`shardmap_sweeps`), ONE psum reduces the (2s+1)² Gram matrix, and the s CG
iterations then run in replicated coefficient space with no communication at
all — alphas, betas, and every residual norm come from the Gram matrix.

Numerics:
  * Jacobi preconditioning is applied as a split similarity transform
    Ã = S A S with S = sqrt(inv_diag) (pointwise), which produces the same
    x-iterates as left-preconditioned CG with M = diag(inv_diag) in exact
    arithmetic. Convergence is tested on the preconditioned residual
    ||S(b - A x)|| <= tol ||S b|| (PETSc's KSP_NORM_PRECONDITIONED default).
  * Residual replacement every outer step: the basis R-chain is seeded from
    the TRUE residual r = S b - Ã x recomputed inside the matrix-powers
    kernel (x rides the same strip exchange as p), so coefficient-space
    drift cannot accumulate across outer steps — the classic s-step CG
    stability fix (Carson & Demmel), here at zero extra communication.
  * basis="monomial" (default, fine for small s) or "chebyshev" (shifted,
    needs lam_min/lam_max of Ã; keeps the basis well-conditioned at larger
    s — the Gram matrix of a monomial basis degrades as kappa^s).

Communication per s iterations: one exchange of s·reach-deep strips of two
fields (p, x) + one (2s+1)² psum, versus s exchanges + 2s psums for
per-iteration CG. The matvec count is ~2s per s iterations (the two-seed
basis needs both the p-chain and the r-chain) — the inherent CA-CG
trade: ~2x local stencil work for a ~s-fold collective-latency cut.

No reference counterpart (the reference is single-process,
SURVEY.md §2.8); the algorithm family is s-step/CA-Krylov (Chronopoulos &
Gear; Carson & Demmel residual replacement).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import jax.numpy as jnp
from jax import lax

from .ca_common import MatrixPowers, _mm, plan_ca_solver, run_ca_solver
from .mesh import GridMesh


def _basis_matrix(lengths, basis: str, theta, delta, dtype):
    """Change-of-basis matrix B with A·V_j = sum_i B[i,j]·V_i per chain.

    `lengths` gives the chain lengths laid out consecutively; CA-CG uses
    (s+1, s) — columns 0..s the p-chain, s+1..2s the r-chain — and CA-GMRES
    a single (s+1,) chain. The top-degree column of each chain is never
    applied by the coefficient recurrences (degree bookkeeping keeps
    coefficients representable), so those columns are zero."""
    m = sum(lengths)
    B = np.zeros((m, m))

    def fill(base, length):
        # chain vectors v_0..v_{length-1} at rows/cols base..base+length-1
        for j in range(length - 1):
            c = base + j
            if basis == "monomial":
                B[c + 1, c] = 1.0
            else:  # chebyshev: A v_j = theta v_j + (delta/2)(v_{j+1}+v_{j-1})
                B[c, c] = theta
                B[c + 1, c] = delta if j == 0 else delta / 2.0
                if j > 0:
                    B[c - 1, c] = delta / 2.0

    base = 0
    for length in lengths:
        fill(base, length)
        base += length
    return jnp.asarray(B, dtype)


def cg_sharded(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    s: int = 4,
    maxiter: int = 200,
    tol: float = 1e-6,
    inv_diag=None,
    basis: str = "monomial",
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
) -> Callable:
    """Build a jittable communication-avoiding CG solve for A = @name.

    Returns solve(b) -> (x, SolveInfo). A must be SPD on its interior (the
    boundary copy-through rows act as identity rows, which keeps SPD-ness
    when inv_diag is 1 there). inv_diag, if given, is the Jacobi
    preconditioner diagonal (an array over the full field domain, sharded
    like b). basis="chebyshev" requires lam_min/lam_max bounding the
    spectrum of Ã = S A S (estimate with `solvers.chebyshev
    .estimate_spectrum` over a `shardmap_opdef` matvec)."""
    sp = plan_ca_solver(
        cm, name, gmesh, s=s, kdepth=s, kdepth_desc="s",
        solver="cg_sharded", basis=basis, lam_min=lam_min, lam_max=lam_max,
    )
    rank, names, need, spec = sp.rank, sp.names, sp.need, sp.spec
    outer, dtype, periodic = sp.outer, sp.dtype, sp.periodic
    theta, delta, matvec_block = sp.theta, sp.delta, sp.matvec_block

    m = 2 * s + 1
    Bmat = _basis_matrix((s + 1, s), basis, theta, delta, dtype)

    def global_fn(b):
        def local_fn(bl, sl):
            # shared matrix-powers machinery (one exchange per block, core
            # chains + trapezoid band replays, honest final matvec)
            mp = MatrixPowers(
                matvec_block=matvec_block, names=names, rank=rank,
                outer=outer, dtype=dtype, periodic=periodic, basis=basis,
                theta=theta, delta=delta,
                need_k=[(s * lo, s * hi) for lo, hi in need],
                need_1=need,
                bl=bl, sl=sl,
            )
            nloc, gsum = mp.nloc, mp.gsum

            b2 = gsum(jnp.sum(mp.btl * mp.btl))
            target2 = jnp.asarray(tol * tol, dtype) * b2

            def outer_body(carry):
                x, p, rr, it, stall, best_x, best_rr = carry
                # ---- one exchange: s-deep strips of (x, p); basis =
                # [p, Ãp, .., Ã^s p, r, Ãr, .., Ã^{s-1} r] with the TRUE
                # residual seed r = b̃ - Ã x (residual replacement) ----
                V = mp.basis_with_replay([x, p], (s + 1, s))

                # ---- one psum: the Gram matrix ----
                Vs = jnp.stack([v.reshape(-1) for v in V])
                G = gsum(_mm(Vs, Vs.T))

                # The block-seed residual norm ||r0||² = G[r,r] is a direct
                # sum of squares of the TRUE residual field — trustworthy.
                # The IN-block updates below estimate norms as Gram
                # quadratic forms of coefficient differences, which bottom
                # out at ~sqrt(eps)·||b̃||² and can round NEGATIVE once the
                # block spans convergence (a degenerate Krylov basis). So:
                # convergence is decided on the seed norm, the in-block
                # estimates only gate the s inner iterations (guarded
                # against pAp <= 0 / rr < 0 breakdown), and breakdown
                # restarts p from the residual (conjugacy is lost anyway).
                rr_seed = G[s + 1, s + 1]
                # best-iterate tracking on the TRUSTED seed metric: once a
                # basis degenerates, in-block steps can pass every Gram
                # guard (their estimates are noise that LOOKS convergent)
                # while slowly polluting x — the returned solution is the
                # best true-residual iterate ever seeded, so late-block
                # wander cannot destroy the answer.
                improved = rr_seed < best_rr
                best_x = jnp.where(improved, x, best_x)
                best_rr = jnp.where(improved, rr_seed, best_rr)
                block_on = rr_seed > target2

                # Conjugacy check on the CARRIED search direction: CG's
                # continuation rests on the exact invariant <r0, p0> =
                # ||r0||² (r is orthogonal to every earlier search
                # direction). A p that came out of a degenerate previous
                # block violates it grossly — and the recurrence below
                # would then AMPLIFY the garbage component every step
                # (beta = rr_new/rr_j > 1 growth spiral, observed: +44%
                # per step on a near-identity operator). Restart p from
                # the residual instead; the invariant holds to roundoff
                # on every healthy trajectory, so exact CG equivalence is
                # untouched (deviation ~eps·||r||·||p|| vs the 0.5·||r0||²
                # threshold).
                rp0 = G[s + 1, 0]
                p_ok = jnp.abs(rp0 - rr_seed) <= 0.5 * rr_seed

                # ---- s CG iterations in replicated coefficient space ----
                x_c = jnp.zeros((m,), dtype)
                r_c = jnp.zeros((m,), dtype).at[s + 1].set(1.0)
                e_p = jnp.zeros((m,), dtype).at[0].set(1.0)
                p_c = jnp.where(p_ok, e_p, r_c)
                rr_j = rr_seed
                it_j = it
                brk = jnp.logical_not(block_on)
                for j_in in range(s):
                    # an r-seeded (restarted) block has only s-1 valid
                    # basis-image applications (the r-chain's top-degree
                    # column is zero in B) — its last slot stays idle
                    valid = p_ok | jnp.asarray(j_in < s - 1)
                    active = (
                        valid
                        & jnp.logical_not(brk)
                        & (rr_j > target2)
                        & (it_j < maxiter)
                    )
                    w_c = _mm(Bmat, p_c)
                    Gp = _mm(G, w_c)
                    pAp = jnp.sum(p_c * Gp)
                    ok = active & (pAp > 0)
                    alpha = jnp.where(
                        ok, rr_j / jnp.where(pAp == 0, 1.0, pAp), 0.0
                    )
                    x_n = x_c + alpha * p_c
                    r_n = r_c - alpha * w_c
                    rr_new = jnp.sum(r_n * _mm(G, r_n))
                    # degenerate-basis guard: a Gram quadratic form can
                    # stay positive while the step is garbage — an in-block
                    # residual JUMP of >10x is never a healthy CG step
                    # (||r|| oscillates, but not like that), so treat it as
                    # breakdown and ROLL BACK the step instead of letting a
                    # runaway alpha pollute x
                    good = ok & (rr_new >= 0) & (rr_new <= 10.0 * rr_j)
                    x_c = jnp.where(good, x_n, x_c)
                    r_c = jnp.where(good, r_n, r_c)
                    brk = brk | (active & jnp.logical_not(good))
                    beta = jnp.where(
                        good, rr_new / jnp.where(rr_j == 0, 1.0, rr_j), 0.0
                    )
                    p_c = jnp.where(good, r_c + beta * p_c, p_c)
                    rr_j = jnp.where(good, rr_new, rr_j)
                    # count only fully-good iterations (same convention as
                    # CA-BiCGStab): the stall counter needs "no good
                    # iteration" to mean "no progress"
                    it_j = it_j + good.astype(jnp.int32)

                # breakdown restart: next block's search direction = residual
                p_c = jnp.where(brk & block_on, r_c, p_c)

                # ---- recover x, p from the basis (local, no comm) ----
                Vstack = jnp.stack(V)
                x = x + jnp.tensordot(x_c, Vstack, axes=1, precision="highest")
                p = jnp.tensordot(p_c, Vstack, axes=1, precision="highest")
                made_progress = it_j > it
                stall = jnp.where(
                    block_on & jnp.logical_not(made_progress), stall + 1,
                    jnp.int32(0),
                )
                # divergence exit: the trusted seed left the best iterate
                # 1e4x behind — stop wandering (a healthy CG block never
                # regresses that far; ||r|| oscillation is ~sqrt(kappa))
                stall = jnp.where(
                    rr_seed > 1e4 * best_rr, jnp.int32(2), stall
                )
                rr_out = jnp.where(block_on, jnp.maximum(rr_j, 0.0), rr_seed)
                return x, p, rr_out, it_j, stall, best_x, best_rr

            def cond(carry):
                _x, _p, rr, it, stall = carry[:5]
                # two consecutive zero-progress blocks = the coefficient
                # space is numerically exhausted; stop and report honestly
                return (it < maxiter) & (rr > target2) & (stall < 2)

            x0 = jnp.zeros(nloc, dtype)
            x, p, rr, it, _stall, best_x, best_rr = lax.while_loop(
                cond, outer_body,
                (x0, mp.btl, b2, jnp.int32(0), jnp.int32(0),
                 x0, jnp.asarray(jnp.inf, dtype)),
            )

            # honest final report: ONE extra exchanged matvec gives the
            # true preconditioned residual of the returned x (the in-block
            # Gram estimates cannot resolve below ~sqrt(eps)). The best-x
            # fallback is a SAFETY NET only: prefer the final iterate (the
            # exact-CG-trajectory contract; ||r|| oscillates, so the final
            # iterate is legitimately not always the minimum) unless it is
            # pathologically worse than the best seeded one — wandering
            # past a degenerate basis, not oscillation.
            rr_cur = mp.true_rr(x)
            take_cur = rr_cur <= 100.0 * best_rr
            x = jnp.where(take_cur, x, best_x)
            rr = jnp.where(take_cur, rr_cur, best_rr)
            # un-transform: x = S y
            if mp.S_loc is not None:
                x = mp.S_loc * x
            return x, rr, it, target2

        return run_ca_solver(local_fn, gmesh, spec, b, inv_diag)

    return global_fn
