"""Shared per-shard machinery for the s-step CA-Krylov solvers.

`ca_cg`, `ca_gmres`, and `ca_bicgstab` all run the same choreography per
outer block: exchange K-deep strips of their carried fields ONCE, build
basis chains with the matrix-powers kernel (zero-ghost on the core,
trapezoid band replay at the edges — the machinery of `sharded_apply`),
reduce ONE Gram matrix, and iterate in replicated coefficient space. This
module holds the solver-independent parts so the choreography exists in
exactly one place:

  * the split-preconditioned operator Ã = S A S (S = sqrt(inv_diag)),
  * monomial/chebyshev basis chains,
  * `basis_with_replay`: strip exchange + core chains + band replays for
    any (carried fields, chain lengths) combination — CG/BiCGStab pass
    [x, p] with a p-chain + r-chain, GMRES passes [x] with one r-chain;
    the r-chain is always seeded from the TRUE residual b̃ - Ã x
    (residual replacement),
  * `true_rr`: the honest final-report matvec (one extra exchange), and
  * `gsum`: psum over exactly the mesh axes that shard the field.

`ca_chebyshev` keeps its own body: it replays a three-field recurrence,
not seed chains.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax, shard_map

from ..ir.types import TempType
from ..solvers.krylov import SolveInfo
from .sharded_apply import (
    _block_apply,
    _fused_plan,
    _gstart,
    _run_band_fixups,
    _single_apply,
    _stitch_band,
    _strip_exchange,
)


def _mm(a, b):
    """f32-exact matmul for coefficient-space algebra.

    A default-precision f32 `@` may multiply at reduced precision (TF32 on
    NVIDIA tensor cores: ~10 mantissa bits); the CA solvers' Gram matrices
    and coefficient recurrences lose enough bits that residuals stall
    orders above tol, or the Chebyshev basis NaNs. Every
    Gram/coefficient/recombination matmul pins precision="highest"
    (negligible next to the exchanges).
    """
    return jnp.matmul(a, b, precision="highest")


class SolverPlan(NamedTuple):
    """Everything the CA solver frontends share: validated opdef geometry,
    the fused-exchange plan, and the per-shard matvec."""

    rank: int
    names: list
    need: list
    spec: object
    outer: object
    dtype: object
    periodic: bool
    theta: float
    delta: float
    matvec_block: object


def plan_ca_solver(
    cm, name, gmesh, *, s, kdepth, kdepth_desc, solver, basis,
    lam_min, lam_max,
):
    """Shared frontend for the CA-Krylov trio: validate the opdef (unary,
    single-result, single-apply), check basis arguments, run `_fused_plan`
    at the solver's chain depth, and build the per-shard matvec.

    kdepth: how many times the basis chains apply Ã per exchange (CG: s,
    GMRES: s+1, BiCGStab: 2s+1); kdepth_desc names it in the eligibility
    error."""
    if s < 1:
        raise ValueError("s must be >= 1")
    if basis not in ("monomial", "chebyshev"):
        raise ValueError(f"unknown basis {basis!r}")
    if basis == "chebyshev" and (lam_min is None or lam_max is None):
        raise ValueError("basis='chebyshev' needs lam_min and lam_max")
    fn = cm.module.lookup(name)
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if len(fn.ftype.inputs) != 1 or len(fn.ftype.results) != 1:
        raise ValueError(f"{solver} needs a unary, single-result opdef")
    op = _single_apply(fn)
    if op is None:
        raise ValueError(f"{solver} needs a single-apply opdef body")
    names = list(gmesh.axis_names[:rank]) + [None] * (
        rank - len(gmesh.axis_names)
    )
    plan = _fused_plan(fn, op, gmesh, names, tt, sweeps_k=kdepth)
    if plan is None:
        raise ValueError(
            f"@{name} is not eligible at s={s} "
            f"(non-constant scalars, or {kdepth_desc}*reach exceeds a shard)"
        )
    need, scalar_vals, _ret_index, _arg_order = plan

    out_type: TempType = op.results[0].type
    if basis == "chebyshev":
        # python floats stay weak-typed (a np.float64 bound would promote
        # f32 fields under x64)
        theta = 0.5 * (float(lam_max) + float(lam_min))
        delta = 0.5 * (float(lam_max) - float(lam_min))
    else:
        theta = delta = 0.0
    return SolverPlan(
        rank=rank,
        names=names,
        need=need,
        spec=gmesh.pspec(rank),
        outer=out_type.bounds,
        dtype=jnp.dtype(out_type.element),
        periodic=bool(op.attrs.get("periodic")),
        theta=theta,
        delta=delta,
        matvec_block=_block_apply(op, names, scalar_vals),
    )


def run_ca_solver(local_fn, gmesh, spec, b, inv_diag):
    """Shared solve tail: shard_map `local_fn(b_block, inv_diag_block)
    -> (x, rr, it, target2)` over the mesh and assemble SolveInfo.

    The whole local body traces under `default_matmul_precision("highest")`
    so library internals the solvers cannot pin per-call (eigh/lstsq in
    CA-GMRES's replicated least squares) get f32-exact matmuls too — see
    `_mm` for why reduced-precision multiplies break the recurrences.
    """
    import jax

    has_id = inv_diag is not None
    idl = inv_diag if has_id else jnp.zeros(())

    def pinned(bb, ii):
        with jax.default_matmul_precision("highest"):
            return local_fn(bb, ii if has_id else None)

    x, rr, it, target2 = shard_map(
        pinned,
        mesh=gmesh.mesh,
        in_specs=(spec, spec if has_id else gmesh.pspec(0)),
        out_specs=(spec,) + (gmesh.pspec(0),) * 3,
        check_vma=False,
    )(b, idl)
    info = SolveInfo(
        iters=it,
        resnorm=jnp.sqrt(rr),
        converged=rr <= target2,
    )
    return x, info


class MatrixPowers:
    """Per-shard state + operations for one CA solve (built inside the
    shard_map local function; all members are traced values)."""

    def __init__(
        self,
        *,
        matvec_block,
        names,
        rank,
        outer,
        dtype,
        periodic,
        basis,
        theta,
        delta,
        need_k,
        need_1,
        bl,
        sl,
    ):
        self.matvec_block = matvec_block
        self.names = names
        self.rank = rank
        self.dtype = dtype
        self.periodic = periodic
        self.basis = basis
        self.theta = theta
        self.delta = delta
        self.need_k = need_k
        self.need_1 = need_1
        self.nloc = bl.shape
        self.gstart = _gstart(self.nloc, rank, names, outer)
        # split-preconditioner S and b̃ = S b; their strips are
        # iteration-constant: exchanged ONCE here, outside any solver loop
        # (XLA cannot hoist collectives out of a while_loop body)
        self.S_loc = None if sl is None else jnp.sqrt(sl.astype(dtype))
        self.btl = (
            bl.astype(dtype) if self.S_loc is None else self.S_loc * bl
        )
        cfields = (
            [self.btl] if self.S_loc is None else [self.btl, self.S_loc]
        )
        self.c_strips, self.c_ext, _ = _strip_exchange(
            cfields, self.nloc, rank, names, need_k, periodic
        )

    # ---- operator and chains -------------------------------------------
    def Amv(self, v, S_blk, bases, shape):
        """Ã v = S * A(S * v) (S=None: plain A)."""
        u = v if S_blk is None else S_blk * v
        w = self.matvec_block(u, bases, shape)
        return w if S_blk is None else S_blk * w

    def chain(self, seed, length, S_blk, bases, shape):
        """[v, Ãv, ...] (monomial) or the shifted Chebyshev chain."""
        vs = [seed]
        for j in range(length - 1):
            Av = self.Amv(vs[-1], S_blk, bases, shape)
            if self.basis == "monomial":
                vs.append(Av)
            elif j == 0:
                vs.append((Av - self.theta * vs[-1]) / self.delta)
            else:
                vs.append(
                    2.0 * (Av - self.theta * vs[-1]) / self.delta - vs[-2]
                )
        return vs

    def _band_consts(self, zone):
        """Stitched (b̃, S) bands for a replay zone."""
        bbt = _stitch_band(
            self.c_ext, self.c_strips, 0, zone.d, zone.side, zone.lo_n,
            zone.hi_n, self.nloc,
        ).astype(self.dtype)
        bS = (
            _stitch_band(
                self.c_ext, self.c_strips, 1, zone.d, zone.side,
                zone.lo_n, zone.hi_n, self.nloc,
            ).astype(self.dtype)
            if self.S_loc is not None
            else None
        )
        return bbt, bS

    def basis_with_replay(self, fields, lengths):
        """The matrix-powers kernel: ONE strip exchange of `fields`
        (fields[0] must be x), core chains, trapezoid band replays.

        lengths = (len_seed1, ..., len_r): one chain per carried seed
        field fields[1:], in order, followed by the r-chain seeded from
        the TRUE residual b̃ - Ã·fields[0]. Returns the 'sum(lengths)'
        basis vectors, boundary-exact.
        """

        def chains_on(blk_fields, bbt, bS, bases, shape):
            out = []
            for seed, L in zip(blk_fields[1:], lengths[:-1]):
                out += self.chain(seed, L, bS, bases, shape)
            r0 = bbt - self.Amv(blk_fields[0], bS, bases, shape)
            out += self.chain(r0, lengths[-1], bS, bases, shape)
            return out

        strips, ext_slice, sharded_dims = _strip_exchange(
            fields, self.nloc, self.rank, self.names, self.need_k,
            self.periodic,
        )
        V = chains_on(
            fields, self.btl, self.S_loc, self.gstart, self.nloc
        )

        def replay(bands, zone):
            bf = [bb.astype(self.dtype) for bb in bands]
            bbt, bS = self._band_consts(zone)
            return chains_on(bf, bbt, bS, zone.bases, bf[0].shape)

        return _run_band_fixups(
            V, len(fields), strips, ext_slice, sharded_dims, self.need_k,
            self.nloc, self.rank, self.gstart, replay,
        )

    # ---- reductions and honest reporting --------------------------------
    def gsum(self, v):
        """psum over exactly the axes that shard this field (extra mesh
        axes hold replicas; summing them would inflate the norms)."""
        for nm in self.names[: self.rank]:
            if nm:
                v = lax.psum(v, nm)
        return v

    def true_rr(self, x):
        """||b̃ - Ã x||² with a fresh exchange + band fixup — the honest
        final report (coefficient-space estimates bottom out at
        ~sqrt(eps); see the solver docstrings).

        One matvec needs only 1x-reach ghosts, so the exchange here is
        1-deep — not the solver's K-deep strips. Exchanging w = S·x (not x)
        makes the band replay a pure stencil apply: with
        r = b̃ - Ã x = b̃ - S·A(S·x) = b̃ - S·(A w), the subtraction and
        both S multiplies act on core rows only, so no constants ride the
        exchange at all — one field, one-deep, cheaper than the solver's
        in-loop rounds in both ppermute count and bytes."""
        w = x if self.S_loc is None else self.S_loc * x
        ts, te, td = _strip_exchange(
            [w], self.nloc, self.rank, self.names, self.need_1,
            self.periodic,
        )
        u_main = self.matvec_block(w, self.gstart, self.nloc)

        def rreplay(bands, zone):
            bw = bands[0].astype(self.dtype)
            return [self.matvec_block(bw, zone.bases, bw.shape)]

        (uf,) = _run_band_fixups(
            [u_main], 1, ts, te, td, self.need_1, self.nloc,
            self.rank, self.gstart, rreplay,
        )
        rf = self.btl - (uf if self.S_loc is None else self.S_loc * uf)
        return self.gsum(jnp.sum(rf * rf))
