"""Explicit shard_map execution of compiled operators.

Complements the GSPMD path (`parallel.sharded`): instead of letting XLA's
partitioner infer the communication, each device runs the operator *locally*
on a halo-extended block — ghost cells fetched once up front by
`halo_pad_local` (lax.ppermute over ICI), boundary masks computed from traced
global coordinates. The halo depth is the opdef's verified `total_shape`
reach, so composite operators (apply_linear chains) need exactly one exchange
per application, not one per stage.

This is the deterministic-communication execution mode; the jnp local
executor is used for the per-shard compute.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map

from ..ir.core import Module, Operation
from ..ir.types import Bounds, ScalarType, TempType
from ..lowering import jnp_backend
from .halo import halo_pad_local
from .mesh import GridMesh


class _ScalarArg(NamedTuple):
    """Marker in a plan's scalar_vals: the scalar comes from opdef arg
    `index` at call time (replicated), not from a body constant."""

    index: int


def _resolve_scalars(scalar_vals, locs):
    """Replace _ScalarArg markers with the caller-supplied local values."""
    return [
        locs[sv.index] if isinstance(sv, _ScalarArg) else sv
        for sv in scalar_vals
    ]


def _scalar_args_trailing(fn):
    """Indices where field args end and ScalarType args begin, or None if
    the signature interleaves them (every sharded path requires fields
    first, scalars trailing — the reference's `fn(x, *scalars)` shape)."""
    kinds = [isinstance(t, ScalarType) for t in fn.ftype.inputs]
    n_fields = kinds.index(True) if any(kinds) else len(kinds)
    if any(not k for k in kinds[n_fields:]) or n_fields == 0:
        return None
    return n_fields

def _eval_apply_local(
    op: Operation,
    ext_arrays,
    scalars,
    ext_shape,
    global_start,
    carve_halo=None,
):
    """Evaluate one apply over a halo-extended local block.

    global_start[d]: traced global logical coordinate of ext row 0 in dim d.
    Boundary copy-through masks compare traced global indices against the
    op's static bounds (the static interior_mask path cannot be used because
    each shard sees a different window).

    carve_halo: when given (the per-dim (lo, hi) ghost widths of ext vs the
    core block), results are computed CORE-shaped directly — every neighbor
    access is a static slice of the aligned-extent core window instead of a
    shape-preserving shift of the ghost-extended (usually tile-misaligned)
    array, which saves the ext-shaped intermediates and the final carve
    copy. Only valid when no later stage reads this result's margins.
    """
    out_type: TempType = op.results[0].type
    n_in = op.attrs.get("num_inputs", len(op.operands))
    bounds: Bounds = op.attrs["bounds"]
    outer = out_type.bounds
    rank = outer.rank

    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]

    if carve_halo is not None:
        lo = tuple(h[0] for h in carve_halo)
        core = tuple(
            e - h[0] - h[1] for e, h in zip(ext_shape, carve_halo)
        )
        # every slice must stay inside ext for all accesses; lb-shifted
        # inputs can push a slice out of range -> shape-preserving fallback
        ok = True
        sshape = op.attrs.get("shape")
        offs = list(sshape.offsets) if sshape and sshape.offsets else [(0,) * rank]
        for k in range(n_in):
            for o in offs:
                for d in range(rank):
                    adj = o[d] + (outer.lb[d] - input_lbs[k][d])
                    if lo[d] + adj < 0 or lo[d] + adj + core[d] > ext_shape[d]:
                        ok = False
        if not ok:
            carve_halo = None

    if carve_halo is not None:

        def access_fn(k, offset):
            adj = tuple(
                o + (lb_o - lb_i)
                for o, lb_o, lb_i in zip(offset, outer.lb, input_lbs[k])
            )
            starts = tuple(l + a for l, a in zip(lo, adj))
            limits = tuple(s + c for s, c in zip(starts, core))
            return jax.lax.slice(ext_arrays[k], starts, limits)

        def index_fn(d):
            iv = jax.lax.broadcasted_iota(jnp.int32, core, d)
            return iv + global_start[d] + lo[d]

        ys = jnp_backend.eval_scalar_dag(
            op.region(0), rank, n_in, access_fn, index_fn, scalars, pinned=False
        )
        dtype = jnp.dtype(out_type.element)
        outs = []
        for j, y in enumerate(ys):
            y = jnp.broadcast_to(jnp.asarray(y, dtype), core)
            if bounds != outer:
                mask = None
                for d in range(rank):
                    iv = index_fn(d)
                    m = (iv >= bounds.lb[d]) & (iv < bounds.ub[d])
                    mask = m if mask is None else (mask & m)
                seed = (
                    jax.lax.slice(
                        ext_arrays[j], lo, tuple(l + c for l, c in zip(lo, core))
                    )
                    if j < n_in
                    else jnp.zeros(core, dtype)
                )
                y = jnp.where(mask, y, seed)
            outs.append(y)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def access_fn(k, offset):
        adj = tuple(
            o + (lo - li) for o, lo, li in zip(offset, outer.lb, input_lbs[k])
        )
        return jnp_backend.shift_read(ext_arrays[k], adj)

    def index_fn(d):
        iv = jax.lax.broadcasted_iota(jnp.int32, ext_shape, d)
        return iv + global_start[d]

    ys = jnp_backend.eval_scalar_dag(
        op.region(0), rank, n_in, access_fn, index_fn, scalars, pinned=False
    )
    dtype = jnp.dtype(out_type.element)
    outs = []
    for j, y in enumerate(ys):
        y = jnp.broadcast_to(jnp.asarray(y, dtype), ext_shape)
        if bounds != outer:
            mask = None
            for d in range(rank):
                iv = index_fn(d)
                m = (iv >= bounds.lb[d]) & (iv < bounds.ub[d])
                mask = m if mask is None else (mask & m)
            seed = (
                ext_arrays[j]
                if j < n_in
                else jnp.zeros(ext_shape, dtype)
            )
            y = jnp.where(mask, y, seed)
        outs.append(y)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _eval_opdef_local(
    module: Module,
    name: str,
    ext_args,
    ext_shape,
    start,
    carve_halo=None,
):
    """Run an opdef body on halo-extended blocks (intermediate results keep
    the extended domain; values in the margin become progressively garbage,
    which is fine — the final interior is within every stage's valid zone
    because the exchange depth is the *composed* reach).

    carve_halo: when given, the RETURNED values are core-shaped (ghost
    margins stripped). Applies whose results feed only `neptune.return` are
    computed core-shaped directly (the fast aligned path in
    `_eval_apply_local`); anything still consumed downstream stays
    ext-shaped and is sliced at the return. Nested opdef calls always run
    ext-shaped (their margins feed later stages)."""
    fn = module.lookup(name)
    env = {a.uid: v for a, v in zip(fn.body.args, ext_args)}
    core_uids: set = set()
    consumed: set = set()
    returned: set = set()
    if carve_halo is not None:
        for op in fn.body.ops:
            tgt = consumed if op.name != "neptune.return" else returned
            for o in op.operands:
                tgt.add(o.uid)

    def _carve(y):
        sl = tuple(
            slice(h[0], e - h[1]) for h, e in zip(carve_halo, ext_shape)
        )
        return y[sl]

    out = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            n_in = op.attrs.get("num_inputs", len(op.operands))
            ins = [env[o.uid] for o in op.operands[:n_in]]
            scs = [env[o.uid] for o in op.operands[n_in:]]
            final = (
                carve_halo is not None
                and all(r.uid not in consumed for r in op.results)
                and any(r.uid in returned for r in op.results)
            )
            res = _eval_apply_local(
                op,
                ins,
                scs,
                ext_shape,
                start,
                carve_halo=carve_halo if final else None,
            )
            vals = res if isinstance(res, tuple) else (res,)
            for r, v in zip(op.results, vals):
                env[r.uid] = v
                # the lb-shift fallback may decline the core path and hand
                # back ext-shaped values; classify by actual shape
                if final and v.shape != tuple(ext_shape):
                    core_uids.add(r.uid)
        elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            sub = _eval_opdef_local(
                module,
                op.attrs["symbol"],
                [env[o.uid] for o in op.operands],
                ext_shape,
                start,
            )
            subs = sub if isinstance(sub, tuple) else (sub,)
            for r, v in zip(op.results, subs):
                env[r.uid] = v
        elif op.name == "arith.constant":
            env[op.results[0].uid] = jnp.asarray(
                op.attrs["value"], jnp_backend._scalar_dtype(op.results[0].type)
            )
        elif op.name == "neptune.return":
            vals = []
            for o in op.operands:
                v = env[o.uid]
                if carve_halo is not None and o.uid not in core_uids:
                    v = _carve(v)
                vals.append(v)
            out = vals[0] if len(vals) == 1 else tuple(vals)
        else:
            raise NotImplementedError(
                f"shard_map opdef execution: unsupported op {op.name}"
            )
    return out


def _opdef_periodic(module: Module, name: str) -> bool:
    """Whether the opdef's applies are periodic (torus). Mixed periodic and
    bounded applies in one operator have no single exchange semantics."""
    flags = set()

    def scan(sym):
        fn = module.lookup(sym)
        for op in fn.body.ops:
            if op.name == "neptune.apply":
                flags.add(bool(op.attrs.get("periodic")))
            elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
                scan(op.attrs["symbol"])

    scan(name)
    if len(flags) > 1:
        raise NotImplementedError(
            f"@{name} mixes periodic and bounded applies; sharded execution "
            "needs a single exchange semantics"
        )
    return bool(flags) and flags.pop()


def _single_apply(fn):
    """The opdef's single apply op, if the body is exactly {constants, one
    apply, return-of-that-apply's-results}; else None."""
    apply_op = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            if apply_op is not None:
                return None
            apply_op = op
        elif op.name in ("arith.constant", "neptune.return"):
            continue
        else:
            return None
    if apply_op is None or fn.body.ops[-1].name != "neptune.return":
        return None
    res_uids = {r.uid: i for i, r in enumerate(apply_op.results)}
    if not all(o.uid in res_uids for o in fn.body.ops[-1].operands):
        return None
    return apply_op


def _fused_plan(fn, op, gmesh, names, tt, sweeps_k: int = 1):
    """Static eligibility + geometry for the fused strip-exchange path.

    Returns (need, scalar_vals, ret_index, arg_uid_order) or None. `need[d]`
    is the (lo, hi) PER-SWEEP reach in dim d (adjusted offsets); the strips
    must carry sweeps_k times that, which the fit check accounts for."""
    rank = tt.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    outer = op.results[0].type.bounds
    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    arg_uids = {a.uid: i for i, a in enumerate(fn.body.args)}
    # apply inputs must be opdef args directly
    for o in op.operands[:n_in]:
        if o.uid not in arg_uids:
            return None
    # scalar operands must be body constants
    const_env = {}
    for cop in fn.body.ops:
        if cop.name == "arith.constant":
            const_env[cop.results[0].uid] = jnp.asarray(
                cop.attrs["value"], jnp_backend._scalar_dtype(cop.results[0].type)
            )
    scalar_vals = []
    for o in op.operands[n_in:]:
        if o.uid in const_env:
            scalar_vals.append(const_env[o.uid])
        elif o.uid in arg_uids and isinstance(o.type, ScalarType):
            # trailing scalar opdef arg: resolved from the call at runtime
            # (replicated); callers run _resolve_scalars over their locs
            scalar_vals.append(_ScalarArg(arg_uids[o.uid]))
        else:
            return None

    sshape = op.attrs.get("shape")
    offs = list(sshape.offsets) if sshape and sshape.offsets else [(0,) * rank]
    need = []
    for d in range(rank):
        lo_n = hi_n = 0
        for k in range(n_in):
            shift = outer.lb[d] - input_lbs[k][d]
            for o in offs:
                adj = o[d] + shift
                lo_n = max(lo_n, -adj)
                hi_n = max(hi_n, adj)
        need.append((lo_n, hi_n))
    # strips come from immediate neighbors only: the K-deep reach must fit
    # one shard (band stitching slices sweeps_k*(lo+hi) core rows)
    for d in range(rank):
        nm = names[d]
        ax = gmesh.shape[gmesh.axis_names.index(nm)] if nm else 1
        if outer.shape[d] % max(ax, 1) != 0:
            return None
        local_d = outer.shape[d] // max(ax, 1)
        if sweeps_k * (need[d][0] + need[d][1]) > local_d:
            return None
    ret = fn.body.ops[-1]
    res_uids = {r.uid: i for i, r in enumerate(op.results)}
    ret_index = [res_uids[o.uid] for o in ret.operands]
    arg_order = [arg_uids[o.uid] for o in op.operands[:n_in]]
    return need, scalar_vals, ret_index, arg_order



def _strip_exchange(inputs_loc, nloc, rank, names, need_k, periodic):
    """ppermute (lo, hi) ghost strips per input per sharded dim, processed
    in dim order so a later dim's strips are cut from the earlier dims'
    extended edges (strips-of-strips — the two-step corner exchange).

    need_k[d] = (lo, hi) ghost depth to exchange in dim d (already scaled
    by the sweep count for the K-sweep path). Non-periodic strips are
    zeroed at the global domain edge; periodic ones keep the ring-wrapped
    data (torus ghosts). Returns (strips, ext_slice, sharded_dims) where
    strips[k][d] = (s_lo, s_hi) and ext_slice(k, d, start, stop) cuts core
    input k to [start, stop) along d extended along every already-exchanged
    dim e < d.
    """
    strips = [dict() for _ in inputs_loc]

    def ext_slice(k, d, start, stop):
        def cut(a):
            return lax.slice_in_dim(a, start, stop, axis=d)

        out = cut(inputs_loc[k])
        for e in range(d):
            if e in strips[k]:
                s_lo, s_hi = strips[k][e]
                parts = []
                if s_lo is not None:
                    parts.append(cut(s_lo))
                parts.append(out)
                if s_hi is not None:
                    parts.append(cut(s_hi))
                if len(parts) > 1:
                    out = jnp.concatenate(parts, axis=e)
        return out

    sharded_dims = []
    for d in range(rank):
        lo_n, hi_n = need_k[d]
        nm = names[d]
        if not nm or (lo_n == 0 and hi_n == 0):
            continue
        sharded_dims.append(d)
        idx = lax.axis_index(nm)
        npart = lax.axis_size(nm)
        fwd = [((i - 1) % npart, i) for i in range(npart)]
        bwd = [((i + 1) % npart, i) for i in range(npart)]
        for k in range(len(inputs_loc)):
            s_lo = s_hi = None
            if lo_n:
                s_lo = lax.ppermute(
                    ext_slice(k, d, nloc[d] - lo_n, nloc[d]), nm, fwd
                )
                if not periodic:
                    s_lo = jnp.where(idx == 0, jnp.zeros_like(s_lo), s_lo)
            if hi_n:
                s_hi = lax.ppermute(ext_slice(k, d, 0, hi_n), nm, bwd)
                if not periodic:
                    s_hi = jnp.where(
                        idx == npart - 1, jnp.zeros_like(s_hi), s_hi
                    )
            strips[k][d] = (s_lo, s_hi)
    return strips, ext_slice, sharded_dims


def _gstart(nloc, rank, names, outer):
    """Traced global logical coordinate of local cell (0,...,0) per dim.
    Must run inside shard_map (reads lax.axis_index)."""
    out = []
    for d in range(rank):
        nm = names[d]
        base = lax.axis_index(nm) * nloc[d] if nm else jnp.int32(0)
        out.append(jnp.asarray(base, jnp.int32) + jnp.int32(outer.lb[d]))
    return out


def _block_apply(op, names, scalar_vals):
    """One zero-ghost masked apply of a single-apply opdef over an arbitrary
    local block: `apply_block(u, bases, shape)` where bases[d] is the traced
    global coordinate of block cell 0 in dim d. Out-of-bounds cells get the
    copy-through value (input0), matching the IR apply contract. The one
    shared implementation behind every fused sharded path's core/band
    sweeps (K-sweep, CA-Chebyshev, CA-CG, CA-MG smoothing)."""
    out_type = op.results[0].type
    outer = out_type.bounds
    bounds: Bounds = op.attrs["bounds"]
    dtype = jnp.dtype(out_type.element)
    rank = outer.rank
    full_domain = bounds == outer
    periodic = bool(op.attrs.get("periodic"))
    wrap = tuple(periodic and not names[d] for d in range(rank))
    input_lb = op.operands[0].type.bounds.lb

    def adj_of(offset):
        return tuple(
            o + (lb_o - lb_i)
            for o, lb_o, lb_i in zip(offset, outer.lb, input_lb)
        )

    def apply_block(u, bases, shape):
        def access_fn(_k, offset):
            return jnp_backend.shift_read(u, adj_of(offset), wrap)

        def index_fn(d):
            iv = lax.broadcasted_iota(jnp.int32, shape, d)
            return iv + bases[d]

        ys = jnp_backend.eval_scalar_dag(
            op.region(0), rank, 1, access_fn, index_fn, scalar_vals, pinned=False
        )
        y = jnp.broadcast_to(jnp.asarray(ys[0], dtype), shape)
        if not full_domain:
            mask = None
            for d in range(rank):
                iv = index_fn(d)
                mk = (iv >= bounds.lb[d]) & (iv < bounds.ub[d])
                mask = mk if mask is None else (mask & mk)
            y = jnp.where(mask, y, u.astype(dtype))
        return y

    return apply_block


def _stitch_band(ext_slice, strips, k, d, side, lo_n, hi_n, nloc):
    """The strip-stitched band array for input k along dim d: ghost strip +
    the adjacent core rows (extended along dims < d), covering the edge
    zone plus every row its recomputation reads."""
    s_lo, s_hi = strips[k][d]
    if side == "lo":
        parts = [s_lo, ext_slice(k, d, 0, lo_n + hi_n)]
    else:
        parts = [ext_slice(k, d, nloc[d] - (lo_n + hi_n), nloc[d]), s_hi]
    parts = [p for p in parts if p is not None]
    return jnp.concatenate(parts, axis=d) if len(parts) > 1 else parts[0]


class _BandZone(NamedTuple):
    """Geometry of one trapezoid band fixup (dim d, one side).

    bases[d2] is the traced global logical coordinate of band row 0 in dim
    d2; out_slice extracts the zone to write back from a *band-shaped*
    result (along d: rows [lo_n, lo_n+out_w); along earlier sharded dims:
    the core extent, carving their ghost margins); pos is the
    dynamic_update_slice position of that zone in the core block."""

    d: int
    side: str
    out_w: int
    lo_n: int
    hi_n: int
    bases: tuple
    out_slice: tuple
    pos: tuple


def _band_zones(strips, sharded_dims, need_k, nloc, rank, gstart):
    """Enumerate trapezoid band-fixup zones — the one shared implementation
    of the band geometry used by every fused sharded path (single-apply,
    K-sweep, composite-chain, CA-Chebyshev, CA-CG)."""
    zones = []
    for d in sharded_dims:
        lo_n, hi_n = need_k[d]
        for side in ("lo", "hi"):
            out_w = lo_n if side == "lo" else hi_n
            if out_w == 0:
                continue
            if side == "lo":
                base_d = gstart[d] - lo_n
                d0_core = 0
            else:
                base_d = gstart[d] + nloc[d] - (lo_n + hi_n)
                d0_core = nloc[d] - out_w
            bases = []
            for d2 in range(rank):
                if d2 == d:
                    bases.append(base_d)
                elif d2 < d and d2 in strips[0]:
                    bases.append(gstart[d2] - need_k[d2][0])
                else:
                    bases.append(gstart[d2])
            sl = [slice(None)] * rank
            sl[d] = slice(lo_n, lo_n + out_w)
            for e in range(d):
                if e in strips[0]:
                    sl[e] = slice(need_k[e][0], need_k[e][0] + nloc[e])
            pos = tuple(d0_core if e == d else 0 for e in range(rank))
            zones.append(
                _BandZone(
                    d, side, out_w, lo_n, hi_n, tuple(bases), tuple(sl), pos
                )
            )
    return zones


def _run_band_fixups(
    outs,
    n_fields,
    strips,
    ext_slice,
    sharded_dims,
    need_k,
    nloc,
    rank,
    gstart,
    replay,
):
    """Recompute every shard-edge zone from strip-stitched bands.

    replay(bands, zone) -> list of len(outs) band results; bands[fi] is the
    stitched band of field fi. A result may be full-band-shaped (the driver
    slices zone.out_slice) or already out_w-thin along zone.d (only the
    earlier dims' margins are carved). Each zone's results overwrite outs at
    zone.pos via dynamic_update_slice."""
    for zone in _band_zones(strips, sharded_dims, need_k, nloc, rank, gstart):
        bands = [
            _stitch_band(
                ext_slice, strips, fi, zone.d, zone.side, zone.lo_n,
                zone.hi_n, nloc,
            )
            for fi in range(n_fields)
        ]
        bouts = replay(bands, zone)
        for j in range(len(outs)):
            sl = list(zone.out_slice)
            if bouts[j].shape[zone.d] == zone.out_w:
                sl[zone.d] = slice(None)
            outs[j] = lax.dynamic_update_slice(
                outs[j], bouts[j][tuple(sl)], zone.pos
            )
    return outs


def _shardmap_fused(cm, fn, op, gmesh, names, spec, tt, plan) -> Callable:
    """Fused sharded single-apply execution: zero-ghost main sweep + thin
    band fixups.

    The halo_pad_local route (ppermute strips concat'd into a ghost-extended
    array) makes the ext array a fusion barrier: XLA materializes it and the
    carve, tripling HBM traffic. Here the main sweep runs directly on the
    aligned core block with slice+pad neighbor reads — fully fused,
    zero-filled shard edges — and the edge bands whose stencils cross shard
    boundaries are then *recomputed* from thin (O(n·h)) band arrays stitched
    from the ppermuted strips, and written over the result with
    dynamic_update_slice.

    Corner values for multi-axis meshes ride the classic two-step exchange:
    dim-d strips are built from the dims<d-extended edge slices (strips of
    strips), so a later dim's band carries earlier dims' ghosts.
    """
    rank = tt.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    out_type: TempType = op.results[0].type
    outer = out_type.bounds
    bounds: Bounds = op.attrs["bounds"]
    dtype = jnp.dtype(out_type.element)
    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    n_results = len(op.results)
    need, scalar_vals, ret_index, arg_order = plan
    full_domain = bounds == outer
    periodic = bool(op.attrs.get("periodic"))
    # torus ops: UNSHARDED dims wrap locally (local extent == global there);
    # sharded dims zero-fill like before — their local wrap would be
    # globally wrong, and the strip bands (whose ring ppermute wraps at the
    # mesh edge, giving torus ghosts for free) recompute those edge zones
    wrap = tuple(periodic and not names[d] for d in range(rank))

    def global_fn(*arrays):
        def local_fn(*locs):
            inputs_loc = [locs[i] for i in arg_order]
            scalars_rt = _resolve_scalars(scalar_vals, locs)
            nloc = inputs_loc[0].shape
            gstart = _gstart(nloc, rank, names, outer)

            def adj_of(k, offset):
                return tuple(
                    o + (lb_o - lb_i)
                    for o, lb_o, lb_i in zip(offset, outer.lb, input_lbs[k])
                )

            # ---- main sweep on the core block (zero-ghost: every cell whose
            # stencil crosses a shard edge is overwritten by a band fixup
            # below, so edge reads may be zeros OR wrap garbage) ----
            def index_fn(d):
                iv = lax.broadcasted_iota(jnp.int32, nloc, d)
                return iv + gstart[d]

            def access_fn(k, offset):
                return jnp_backend.shift_read(
                    inputs_loc[k], adj_of(k, offset), wrap
                )

            ys = jnp_backend.eval_scalar_dag(
                op.region(0), rank, n_in, access_fn, index_fn, scalars_rt, pinned=False
            )
            outs = []
            for j, y in enumerate(ys):
                y = jnp.broadcast_to(jnp.asarray(y, dtype), nloc)
                if not full_domain:
                    mask = None
                    for d in range(rank):
                        iv = index_fn(d)
                        m = (iv >= bounds.lb[d]) & (iv < bounds.ub[d])
                        mask = m if mask is None else (mask & m)
                    seed = (
                        inputs_loc[j].astype(dtype)
                        if j < n_in
                        else jnp.zeros(nloc, dtype)
                    )
                    y = jnp.where(mask, y, seed)
                outs.append(y)

            # ---- strip exchange (per input, per sharded dim, in order) ----
            strips, ext_slice, sharded_dims = _strip_exchange(
                inputs_loc, nloc, rank, names, need, periodic
            )

            # ---- band fixups: recompute the rows whose stencil crossed a
            # shard edge, from thin strip-stitched bands. The replay computes
            # only the out_w output rows (thin-sliced accesses), not the full
            # band — the k=1 special case the shared driver supports. ----
            def replay(band_in, zone):
                d, out_w = zone.d, zone.out_w
                ghost = zone.lo_n
                d0_core = zone.pos[d]
                bshape = list(band_in[0].shape)
                bshape[d] = out_w
                bshape = tuple(bshape)

                def b_access(k, offset):
                    adj = adj_of(k, offset)
                    v = lax.slice_in_dim(
                        band_in[k],
                        ghost + adj[d],
                        ghost + adj[d] + out_w,
                        axis=d,
                    )
                    rest = tuple(
                        0 if e == d else adj[e] for e in range(rank)
                    )
                    return jnp_backend.shift_read(v, rest, wrap)

                def b_index(d2):
                    iv = lax.broadcasted_iota(jnp.int32, bshape, d2)
                    base = zone.bases[d2]
                    if d2 == d:
                        base = gstart[d] + d0_core
                    return iv + base

                bys = jnp_backend.eval_scalar_dag(
                    op.region(0), rank, n_in, b_access, b_index, scalars_rt, pinned=False
                )
                res = []
                for j, y in enumerate(bys):
                    y = jnp.broadcast_to(jnp.asarray(y, dtype), bshape)
                    if not full_domain:
                        mask = None
                        for d2 in range(rank):
                            iv = b_index(d2)
                            m = (iv >= bounds.lb[d2]) & (iv < bounds.ub[d2])
                            mask = m if mask is None else (mask & m)
                        if j < n_in:
                            seed = ext_slice(
                                j, d, d0_core, d0_core + out_w
                            ).astype(dtype)
                        else:
                            seed = jnp.zeros(bshape, dtype)
                        y = jnp.where(mask, y, seed)
                    res.append(y)
                return res

            outs = _run_band_fixups(
                outs, n_in, strips, ext_slice, sharded_dims, need, nloc,
                rank, gstart, replay,
            )

            vals = [outs[i] for i in ret_index]
            return vals[0] if len(vals) == 1 else tuple(vals)

        n_out = len(fn.ftype.results)
        in_specs = tuple(
            gmesh.pspec(0) if isinstance(t, ScalarType) else spec
            for t in fn.ftype.inputs
        )
        return shard_map(
            local_fn,
            mesh=gmesh.mesh,
            in_specs=in_specs,
            out_specs=(spec,) * n_out if n_out > 1 else spec,
            check_vma=False,
        )(*arrays)

    return global_fn



def _composite_fused_ok(cm, fn, gmesh, names, tt, halo) -> bool:
    """Eligibility of a composite (multi-stage) opdef for the fused
    strip-exchange path: every field arg of the same bounds (trailing
    scalar args allowed — replicated), uniform non-periodic applies,
    composed reach fitting one shard."""
    rank = tt.bounds.rank
    n_fields = _scalar_args_trailing(fn)
    if n_fields is None:
        return False
    for t in fn.ftype.inputs[:n_fields]:
        b = getattr(t, "bounds", None)
        if b is None or b.shape != tt.bounds.shape:
            return False
    try:
        if _opdef_periodic(cm.module, fn.name):
            return False
    except NotImplementedError:
        return False
    for d in range(rank):
        nm = names[d]
        ax = gmesh.shape[gmesh.axis_names.index(nm)] if nm else 1
        if tt.bounds.shape[d] % max(ax, 1) != 0:
            return False
        local_d = tt.bounds.shape[d] // max(ax, 1)
        if halo[d][0] + halo[d][1] > local_d:
            return False
    return True


def _shardmap_fused_composite(
    cm, fn, gmesh, names, spec, tt, halo
) -> Callable:
    """Fused strip-exchange execution for composite (multi-stage) opdefs.

    The whole chain runs zero-ghost on the core block (each stage's wrong
    zone grows by its stage reach; after the chain it is exactly the
    composed reach — the opdef's verified `halo`), then the composed-reach
    edge bands are recomputed by running the SAME chain on thin
    strip-stitched bands of every argument — the k=1 trapezoid with "one
    sweep = the whole operator body". This avoids materializing the
    ghost-extended block (a fusion barrier that triples HBM traffic).
    Trailing scalar opdef args are replicated and flow through both chain
    evaluations.
    """
    rank = tt.bounds.rank
    n_fields = _scalar_args_trailing(fn)
    n_out = len(fn.ftype.results)
    outer = tt.bounds

    def global_fn(*arrays):
        def local_fn(*locs):
            flocs, slocs = list(locs[:n_fields]), list(locs[n_fields:])
            nloc = flocs[0].shape
            gstart = _gstart(nloc, rank, names, outer)

            # main: the whole chain, zero-ghost, on the cores; edge garbage
            # lands inside the composed-reach zones the bands recompute
            out = _eval_opdef_local(
                cm.module, fn.name, list(locs), nloc, gstart
            )
            outs = list(out) if isinstance(out, tuple) else [out]

            strips, ext_slice, sharded_dims = _strip_exchange(
                flocs, nloc, rank, names, halo, False
            )

            def replay(band_args, zone):
                bout = _eval_opdef_local(
                    cm.module, fn.name, band_args + slocs,
                    band_args[0].shape, list(zone.bases),
                )
                return list(bout) if isinstance(bout, tuple) else [bout]

            outs = _run_band_fixups(
                outs, n_fields, strips, ext_slice, sharded_dims, halo, nloc,
                rank, gstart, replay,
            )
            return outs[0] if len(outs) == 1 else tuple(outs)

        in_specs = tuple(
            gmesh.pspec(0) if isinstance(t, ScalarType) else spec
            for t in fn.ftype.inputs
        )
        return shard_map(
            local_fn,
            mesh=gmesh.mesh,
            in_specs=in_specs,
            out_specs=(spec,) * n_out if n_out > 1 else spec,
            check_vma=False,
        )(*arrays)

    return global_fn


class RoutePlan(NamedTuple):
    """The statically-selected sharded execution route for one opdef —
    the single source of truth `shardmap_opdef` dispatches on and
    `plan_report` renders (golden-pinnable; VERDICT r2 missing #9's
    "sharded program" golden)."""

    kind: str  # "fused-strip" | "fused-composite" | "extended-block"
    fn: object
    halo: tuple
    names: list
    spec: object
    tt: TempType
    n_fields: int
    periodic: object  # bool for extended-block; None when not consulted
    apply_op: object  # the single apply op (fused-strip only)
    fused: object  # (need, scalar_vals, ret_index, arg_order) or None


def plan_opdef(cm, name: str, gmesh: GridMesh) -> RoutePlan:
    """Select the sharded execution route for opdef @name on gmesh.

    Route preference (same order the reference's runtime-lowering picks its
    dispatch, `/root/reference/lib/Transform/RuntimeLowering.cpp` — here
    re-decided for shard_map): single-apply opdefs whose reach fits one
    shard take the fused strip-exchange path; eligible composite chains take
    the composite fused path; everything else (reach > shard, periodic
    composites) falls back to the ghost-extended-block path.
    """
    fn = cm.module.lookup(name)
    halo = fn.attrs.get("halo")
    if halo is None:
        raise ValueError(
            f"@{name} has no halo annotation; compile the module through the "
            "pipeline (verify_and_annotate) first"
        )
    n_fields = _scalar_args_trailing(fn)
    if n_fields is None:
        raise ValueError(
            f"@{name}: sharded execution requires field args first and "
            "scalar args trailing (fn(x, ..., *scalars))"
        )
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if not halo:
        halo = tuple((0, 0) for _ in range(rank))
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))
    spec = gmesh.pspec(rank)

    apply_op = _single_apply(fn)
    if apply_op is not None:
        plan = _fused_plan(fn, apply_op, gmesh, names, tt)
        if plan is not None:
            return RoutePlan(
                "fused-strip", fn, halo, names, spec, tt, n_fields,
                None, apply_op, plan,
            )
    elif _composite_fused_ok(cm, fn, gmesh, names, tt, halo):
        return RoutePlan(
            "fused-composite", fn, halo, names, spec, tt, n_fields,
            False, None, None,
        )

    periodic = _opdef_periodic(cm.module, name)
    return RoutePlan(
        "extended-block", fn, halo, names, spec, tt, n_fields,
        periodic, None, None,
    )


def plan_report(cm, name: str, gmesh: GridMesh) -> str:
    """Deterministic textual dump of the sharded execution plan — the
    sharded analog of the pipeline stage dumps, pinned byte-for-byte by
    `tests/golden/sharded_*_plan.txt`."""
    rp = plan_opdef(cm, name, gmesh)
    tt, rank = rp.tt, rp.tt.bounds.rank
    grid = "x".join(str(s) for s in tt.bounds.shape)
    mesh = " ".join(
        f"{n}={s}" for n, s in zip(gmesh.axis_names, gmesh.shape)
    )
    local = "x".join(
        str(
            tt.bounds.shape[d]
            // (gmesh.shape[gmesh.axis_names.index(rp.names[d])] if rp.names[d] else 1)
        )
        for d in range(rank)
    )
    lines = [
        f"opdef @{name}  rank={rank}  grid={grid}  dtype={tt.element}",
        f"mesh: {mesh} ({gmesh.n_devices} devices)  local block={local}",
        f"route: {rp.kind}",
        "halo (verified reach): "
        + " ".join(f"d{d}=({lo},{hi})" for d, (lo, hi) in enumerate(rp.halo)),
    ]
    if rp.kind == "fused-strip":
        need, scalar_vals, _, arg_order = rp.fused
        ex = [
            f"d{d}=({lo},{hi})" if rp.names[d] else f"d{d}=unsharded"
            for d, (lo, hi) in enumerate(need)
        ]
        lines.append("exchange: per-sweep ghost strips " + " ".join(ex))
        lines.append(
            f"apply: {len(arg_order)} field input(s), "
            f"{len(scalar_vals)} scalar operand(s) "
            f"({sum(1 for s in scalar_vals if isinstance(s, _ScalarArg))} "
            "from trailing opdef args)"
        )
    else:
        lines.append(
            "exchange: one composed-reach ghost exchange per application"
        )
        lines.append(
            f"fields: {rp.n_fields} leading, "
            f"{len(rp.fn.ftype.inputs) - rp.n_fields} trailing scalar(s)"
        )
    if rp.periodic is not None:
        lines.append(f"periodic: {'yes' if rp.periodic else 'no'}")
    lines.append(f"outputs: {len(rp.fn.ftype.results)}")
    return "\n".join(lines) + "\n"


def shardmap_opdef(cm, name: str, gmesh: GridMesh) -> Callable:
    """Explicit-communication sharded matvec for opdef @name.

    cm: a CompiledModule over a *verified* module (halo annotations present).
    Single-apply opdefs take the fused strip-exchange path
    (`_shardmap_fused`); eligible composite operators the fused composite
    path; the rest the ghost-extended-block path (`plan_opdef`). Returns a
    jittable global function over mesh-sharded arrays.
    """
    rp = plan_opdef(cm, name, gmesh)
    fn, halo, names, spec, tt = rp.fn, rp.halo, rp.names, rp.spec, rp.tt
    rank = tt.bounds.rank
    n_fields = rp.n_fields
    if rp.kind == "fused-strip":
        return _shardmap_fused(
            cm, fn, rp.apply_op, gmesh, names, spec, tt, rp.fused
        )
    if rp.kind == "fused-composite":
        return _shardmap_fused_composite(cm, fn, gmesh, names, spec, tt, halo)

    periodic = rp.periodic

    def global_fn(*arrays):
        def local_fn(*locs):
            local_shape = locs[0].shape
            exts = [
                halo_pad_local(x, halo, names, periodic=periodic)
                for x in locs[:n_fields]
            ] + list(locs[n_fields:])
            ext_shape = exts[0].shape
            start = []
            for d in range(rank):
                nm = names[d]
                base = (
                    lax.axis_index(nm) * local_shape[d] if nm else jnp.int32(0)
                )
                start.append(
                    jnp.asarray(base, jnp.int32)
                    - jnp.int32(halo[d][0])
                    + jnp.int32(tt.bounds.lb[d])
                )
            return _eval_opdef_local(
                cm.module,
                name,
                exts,
                ext_shape,
                start,
                carve_halo=halo,
            )

        n_out = len(fn.ftype.results)
        in_specs = tuple(
            gmesh.pspec(0) if isinstance(t, ScalarType) else spec
            for t in fn.ftype.inputs
        )
        return shard_map(
            local_fn,
            mesh=gmesh.mesh,
            in_specs=in_specs,
            out_specs=(spec,) * n_out if n_out > 1 else spec,
            check_vma=False,
        )(*arrays)

    return global_fn


def shardmap_sweeps(cm, name: str, gmesh: GridMesh, k: int) -> Callable:
    """K fused relaxation sweeps per halo exchange (communication-avoiding).

    The sharded analog of `cm.sweeps(name, k)`: instead of K alternating
    (exchange, sweep) rounds, each call exchanges K-deep ghost strips ONCE
    and then runs K sweeps locally — 1/K the messages and collective
    latency for the same total ghost bytes. Local correctness follows the
    overlapping-trapezoid scheme:

    * main: K zero-ghost sweeps on the core block (each sweep's wrong zone
      grows by the stencil reach, to K·reach after K sweeps);
    * bands: per sharded dim, the K·reach edge zone is recomputed exactly
      from a thin strip-stitched band of width K·(2·lo+hi) (resp.
      K·(lo+2·hi)): the valid zone of a K-sweep chain on that band shrinks
      by `reach` per sweep and lands exactly on the K·reach output zone;
    * corners ride the strips-of-strips two-step exchange, and later dims'
      band fixups overwrite earlier dims' corner cells with values computed
      from fully-extended data.

    Equivalent to K applications of `shardmap_opdef(...)` (same masks and
    copy-through semantics each sweep). Eligibility: unary single-result
    single-apply opdefs (bounded or torus-periodic) with K·reach fitting
    one shard;
    anything else raises ValueError.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    fn = cm.module.lookup(name)
    halo = fn.attrs.get("halo")
    if halo is None:
        raise ValueError(
            f"@{name} has no halo annotation; compile the module through the "
            "pipeline (verify_and_annotate) first"
        )
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if _scalar_args_trailing(fn) != 1 or len(fn.ftype.results) != 1:
        raise ValueError(
            "shardmap_sweeps requires a single-result opdef with one field "
            "arg (trailing scalar args allowed)"
        )
    op = _single_apply(fn)
    if op is None:
        raise ValueError(
            "shardmap_sweeps requires a single-apply opdef body "
            "(composite operators cannot be time-skewed as one trapezoid)"
        )
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))
    plan = _fused_plan(fn, op, gmesh, names, tt, sweeps_k=k)
    if plan is None:
        raise ValueError(
            f"@{name} is not eligible for fused sharded sweeps at k={k} "
            "(non-constant scalars, or K*reach exceeds a shard)"
        )
    need, scalar_vals, ret_index, arg_order = plan
    spec = gmesh.pspec(rank)

    n_in = op.attrs.get("num_inputs", len(op.operands))
    out_type: TempType = op.results[0].type
    outer = out_type.bounds
    bounds: Bounds = op.attrs["bounds"]
    dtype = jnp.dtype(out_type.element)
    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    full_domain = bounds == outer
    periodic = bool(op.attrs.get("periodic"))
    # torus ops: unsharded dims wrap locally each sweep; sharded dims
    # zero-fill and rely on the band fixups (whose ring ppermute wraps at
    # the mesh edge, giving torus ghosts for free)
    wrap = tuple(periodic and not names[d] for d in range(rank))

    def global_fn(x, *scal):
        def local_fn(xl, *sl):
            scalars_rt = _resolve_scalars(scalar_vals, [xl, *sl])
            nloc = xl.shape
            gstart = _gstart(nloc, rank, names, outer)

            def adj_of(offset):
                return tuple(
                    o + (lb_o - lb_i)
                    for o, lb_o, lb_i in zip(offset, outer.lb, input_lbs[0])
                )

            # one masked zero-ghost sweep over an arbitrary block, with
            # per-dim global index bases (shape-preserving)
            def sweep_block(u, bases, shape):
                def access_fn(_k, offset):
                    return jnp_backend.shift_read(u, adj_of(offset), wrap)

                def index_fn(d):
                    iv = lax.broadcasted_iota(jnp.int32, shape, d)
                    return iv + bases[d]

                ys = jnp_backend.eval_scalar_dag(
                    op.region(0), rank, 1, access_fn, index_fn, scalars_rt, pinned=False
                )
                y = jnp.broadcast_to(jnp.asarray(ys[0], dtype), shape)
                if not full_domain:
                    mask = None
                    for d in range(rank):
                        iv = index_fn(d)
                        m = (iv >= bounds.lb[d]) & (iv < bounds.ub[d])
                        mask = m if mask is None else (mask & m)
                    y = jnp.where(mask, y, u.astype(dtype))
                return y

            # ---- main: K zero-ghost sweeps on the core ----
            y = xl
            for _ in range(k):
                y = sweep_block(y, gstart, nloc)

            # ---- K-deep strip exchange (strips of strips for corners) ----
            need_k = [(k * lo, k * hi) for lo, hi in need]
            strips_all, ext_slice_k, sharded_dims = _strip_exchange(
                [xl], nloc, rank, names, need_k, periodic
            )

            # ---- K-sweep trapezoid band fixups ----
            def replay(bands, zone):
                band = bands[0].astype(dtype)
                for _ in range(k):
                    band = sweep_block(band, zone.bases, band.shape)
                return [band]

            (y,) = _run_band_fixups(
                [y], 1, strips_all, ext_slice_k, sharded_dims, need_k,
                nloc, rank, gstart, replay,
            )
            return y

        n_scal = len(fn.ftype.inputs) - 1
        return shard_map(
            local_fn,
            mesh=gmesh.mesh,
            in_specs=(spec,) + (gmesh.pspec(0),) * n_scal,
            out_specs=spec,
            check_vma=False,
        )(x, *scal)

    return global_fn
