"""Communication-avoiding Chebyshev: K solver iterations per halo exchange.

Chebyshev iteration is already reduction-free (`solvers.chebyshev`: no inner
products in the loop), so on a device mesh its only per-iteration
collectives are the matvec's halo ppermutes. This module removes those too:
the whole (x, r, d) recurrence advances K iterations per ghost exchange via
the same overlapping-trapezoid scheme as `shardmap_sweeps`.

Why it works: per iteration, d and x update POINTWISE (z = M r is diagonal,
the d/x axpys are elementwise) — only `r <- r - A d` reads neighbors. Shard-
edge corruption therefore spreads exactly one stencil reach per iteration
through the r<-d coupling, so after K zero-ghost iterations on the local
core only the K·reach edge zones are wrong, and they are recomputed exactly
from strip-stitched bands of the chunk-start state (x, r, d — all three
fields' ghost values enter the band recurrence) plus the diagonal
preconditioner's ghosts (exchanged once per solve; it is iteration-
constant). The Chebyshev scalars (rho recurrence) are mesh-replicated and
replayed identically inside each band.

Communication: ceil(maxiter/K) exchanges of 3 K-deep field strips instead
of maxiter exchanges of one reach-deep strip — the per-iteration ICI
latency floor drops by ~K (ghost bytes grow 3x, which is noise next to the
latency win), and the exchanges within a chunk have no serial dependency.

No reference counterpart (the reference has no distributed execution at
all, SURVEY.md §2.8); the algorithm family is the s-step/CA-Krylov line of
work, which device meshes reward when collective latency, not bandwidth,
bounds small-iteration solvers.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
from jax import lax
from jax import shard_map

from ..ir.types import TempType
from ..solvers.krylov import SolveInfo
from .mesh import GridMesh
from .sharded_apply import (
    _block_apply,
    _fused_plan,
    _gstart,
    _run_band_fixups,
    _single_apply,
    _stitch_band,
    _strip_exchange,
)


def chebyshev_sharded(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    lam_min,
    lam_max,
    k_fuse: int = 8,
    maxiter: int = 96,
    tol: float = 1e-6,
    inv_diag=None,
    check_every: int = 0,
) -> Callable:
    """Build a jittable communication-avoiding Chebyshev solve for A = @name.

    Returns solve(b) -> (x, SolveInfo). lam_min/lam_max bound the spectrum
    of (M A) with M = diag(inv_diag) (or identity); estimate them with
    `solvers.chebyshev.estimate_spectrum` over a `shardmap_opdef` matvec if
    unknown. The loop runs whole chunks: 1 + ceil((maxiter-1)/k_fuse) *
    k_fuse iterations total (the seed step plus full chunks — at most
    k_fuse-1 beyond maxiter). The residual norm is
    reduced ONCE at the end (the solve loop itself is collective-free apart
    from the per-chunk strip ppermutes). check_every=c (chunks) opts into a
    convergence test — one psum per c*k_fuse iterations — and stops the
    chunk loop early; check_every=0 (default) runs all chunks reduction-
    free. The reported iteration count includes any early stop.

    Residual replacement (automatic, matching `solvers.chebyshev`): every
    check boundary recomputes the TRUE b - A·x with one extra exchanged
    matvec and rebases the recurrence on it, so both the convergence test
    and the returned resnorm are drift-free — the f32 recurrence residual
    otherwise drifts ~1e-5 relative over thousands of iterations.
    """
    if k_fuse < 1:
        raise ValueError("k_fuse must be >= 1")
    fn = cm.module.lookup(name)
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if len(fn.ftype.inputs) != 1 or len(fn.ftype.results) != 1:
        raise ValueError("chebyshev_sharded needs a unary, single-result opdef")
    op = _single_apply(fn)
    if op is None:
        raise ValueError("chebyshev_sharded needs a single-apply opdef body")
    names = list(gmesh.axis_names[:rank]) + [None] * (
        rank - len(gmesh.axis_names)
    )
    plan = _fused_plan(fn, op, gmesh, names, tt, sweeps_k=k_fuse)
    if plan is None:
        raise ValueError(
            f"@{name} is not eligible at k_fuse={k_fuse} "
            "(non-constant scalars, or K*reach exceeds a shard)"
        )
    need, scalar_vals, _ret_index, _arg_order = plan
    spec = gmesh.pspec(rank)

    out_type: TempType = op.results[0].type
    outer = out_type.bounds
    dtype = jnp.dtype(out_type.element)
    periodic = bool(op.attrs.get("periodic"))

    # the seeding step counts as iteration 1 (as in solvers.chebyshev),
    # so the chunk loop covers the remaining maxiter-1 iterations
    n_chunks = -(-(maxiter - 1) // k_fuse)
    theta = 0.5 * (float(lam_max) + float(lam_min))  # python floats stay weak-typed (a np.float64 bound would promote f32 fields under x64)
    delta = 0.5 * (float(lam_max) - float(lam_min))
    sigma1 = theta / delta

    matvec_block = _block_apply(op, names, scalar_vals)

    def global_fn(b):
        def local_fn(bl, idl):
            nloc = bl.shape
            gstart = _gstart(nloc, rank, names, outer)

            def Mz(r, idiag):
                return r if idiag is None else idiag * r

            def k_iters(x, r, d, rho_prev, idiag, bases, shape):
                """K Chebyshev iterations with the zero-ghost local matvec."""
                for _ in range(k_fuse):
                    z = Mz(r, idiag)
                    rho = 1.0 / (2.0 * sigma1 - rho_prev)
                    d = (2.0 * rho / delta) * z + (rho * rho_prev) * d
                    x = x + d
                    r = r - matvec_block(d, bases, shape)
                    rho_prev = rho
                return x, r, d, rho_prev

            def true_residual(xc):
                """b - A·x with a 1x-reach exchange + band fixup (one
                extra matvec). Used three ways: to seed the recurrence,
                to rebase it at every check boundary (what keeps the long
                f32 recurrence drift-free), and for the final report — so
                resnorm is never the drifted recurrence value."""
                ts, te, td = _strip_exchange(
                    [xc], nloc, rank, names, need, periodic
                )
                Ax = matvec_block(xc, gstart, nloc)
                (Ax,) = _run_band_fixups(
                    [Ax], 1, ts, te, td, need, nloc, rank, gstart,
                    lambda bands, zone: [
                        matvec_block(bb, zone.bases, bb.shape)
                        for bb in bands
                    ],
                )
                return bl - Ax

            # ---- initial step (matches solvers.chebyshev's first move) ----
            # r0 = b - A*0 = b; d0 = z0/theta; x1 = d0; r1 = r0 - A d0
            # = true_residual(x1) since x1 = d0
            z0 = Mz(bl, idl)
            d0 = z0 / theta
            x = d0
            r = true_residual(x)
            # concrete dtype for the fori_loop carry (weak-typed python
            # scalars would change type after one chunk)
            rho_prev = jnp.asarray(1.0 / sigma1, dtype)

            # ---- chunked CA loop (fori_loop: one traced chunk body) ----
            need_k = [(k_fuse * lo, k_fuse * hi) for lo, hi in need]
            # the preconditioner diagonal is iteration-constant: exchange
            # its K-deep strips ONCE, outside the loop (XLA cannot hoist
            # collectives out of a fori_loop body)
            id_strips = id_ext = None
            if idl is not None:
                id_strips, id_ext, _ = _strip_exchange(
                    [idl], nloc, rank, names, need_k, periodic
                )

            def chunk_body(_, carry):
                x, r, d0, rho_prev = carry
                strips, ext_slice, sharded_dims = _strip_exchange(
                    [x, r, d0], nloc, rank, names, need_k, periodic
                )
                xm, rm, dm, rhom = k_iters(
                    x, r, d0, rho_prev, idl, gstart, nloc
                )

                # band fixups: replay the K iterations on strip-stitched
                # bands of the chunk-start state (plus the iteration-
                # constant preconditioner diagonal's own band)
                def replay(bands, zone):
                    bx, br, bd = (b.astype(dtype) for b in bands)
                    bid = (
                        _stitch_band(
                            id_ext, id_strips, 0, zone.d, zone.side,
                            zone.lo_n, zone.hi_n, nloc,
                        )
                        if idl is not None
                        else None
                    )
                    fx, fr, fd, _ = k_iters(
                        bx, br, bd, rho_prev, bid, zone.bases, bx.shape
                    )
                    return [fx, fr, fd]

                xm, rm, dm = _run_band_fixups(
                    [xm, rm, dm], 3, strips, ext_slice, sharded_dims,
                    need_k, nloc, rank, gstart, replay,
                )
                return xm, rm, dm, rhom

            def gsum(v):
                # psum only over axes that shard this field: extra mesh
                # axes hold replicas, and summing over them would inflate
                # the norms by the replica count
                for nm in names[:rank]:
                    if nm:
                        v = lax.psum(v, nm)
                return v

            if check_every <= 0:
                x, r, d0, rho_prev = lax.fori_loop(
                    0, n_chunks, chunk_body, (x, r, d0, rho_prev)
                )
                # the loop itself stays reduction-free; the final report
                # rebases on the true residual (solvers.chebyshev parity)
                r = true_residual(x)
                done_chunks = jnp.int32(n_chunks)
            else:
                b2g = gsum(jnp.sum(bl * bl))
                target2 = (tol * tol) * b2g

                def cond(state):
                    ic, r2_c, _ = state
                    return (ic < n_chunks) & (r2_c > target2)

                def body(state):
                    ic, _, carry = state
                    # run check_every chunks (clamped at the tail), then
                    # rebase the recurrence on the true residual and test it
                    trips = jnp.minimum(
                        jnp.int32(check_every), jnp.int32(n_chunks) - ic
                    )
                    carry = lax.fori_loop(0, trips, chunk_body, carry)
                    x_c, _, d_c, rho_c = carry
                    r_c = true_residual(x_c)
                    r2_c = gsum(jnp.sum(r_c * r_c))
                    return ic + trips, r2_c, (x_c, r_c, d_c, rho_c)

                r2_0 = gsum(jnp.sum(r * r))
                i, _, (x, r, d0, rho_prev) = lax.while_loop(
                    cond, body, (jnp.int32(0), r2_0, (x, r, d0, rho_prev))
                )
                done_chunks = i

            # ---- one final reduction: residual and rhs norms ----
            r2 = gsum(jnp.sum(r * r))
            b2 = gsum(jnp.sum(bl * bl))
            return x, r2, b2, done_chunks

        idl = inv_diag if inv_diag is not None else jnp.zeros(())
        has_id = inv_diag is not None
        x, r2, b2, done_chunks = shard_map(
            lambda bb, ii: local_fn(bb, ii if has_id else None),
            mesh=gmesh.mesh,
            in_specs=(spec, spec if has_id else gmesh.pspec(0)),
            out_specs=(spec, gmesh.pspec(0), gmesh.pspec(0), gmesh.pspec(0)),
            check_vma=False,
        )(b, idl)
        resnorm = jnp.sqrt(r2)
        bnorm = jnp.sqrt(b2)
        info = SolveInfo(
            iters=jnp.int32(1) + done_chunks * jnp.int32(k_fuse),
            resnorm=resnorm,
            converged=resnorm <= tol * bnorm,
        )
        return x, info

    return global_fn
