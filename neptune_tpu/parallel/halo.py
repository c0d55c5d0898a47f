"""Explicit halo exchange via shard_map + lax.ppermute.

The shard_map path, for per-shard code whose exchange the caller schedules
itself instead of leaving it to XLA's GSPMD partitioner. Halo widths come from the stencil-shape reach
analysis (`neptune_tpu.ir.verify`, the metadata the reference models with
`StencilShapeAttr`, NeptuneIRAttrs.td:53-76).

Ghost values beyond the *global* domain edge are zero-filled: reads outside
the domain are unspecified by the apply contract (kernels mask them with
`where`, as the reference's boundary-residual kernels do with scf.if), so any
finite fill is valid.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp
from jax import lax
from jax import shard_map

from .mesh import GridMesh


def _axis_size(name: str) -> int:
    return lax.axis_size(name)


def halo_pad_local(
    u_loc,
    halo: Sequence[tuple[int, int]],
    axis_names: Sequence[str],
    periodic: bool = False,
):
    """Inside shard_map: pad the local block with neighbor data per dim.

    halo[d] = (lo, hi) ghost widths for grid dim d; axis_names[d] is the mesh
    axis sharding that dim ('' / None = unsharded, pad with zeros only).
    Returns the extended local array of shape local + lo + hi per dim.

    periodic=True gives torus semantics: the ring ppermute already wraps at
    the mesh boundary, so the global-edge ghosts keep the wrapped data
    instead of being zeroed, and unsharded dims pad with mode="wrap".
    """
    out = u_loc
    for d, (lo, hi) in enumerate(halo):
        if lo == 0 and hi == 0:
            continue
        name = axis_names[d] if d < len(axis_names) else None
        if name:
            idx = lax.axis_index(name)
            n = lax.axis_size(name)
            # send my low-edge slab to the left neighbor's high ghost, etc.
            lo_sl = lax.slice_in_dim(out, 0, max(hi, 1), axis=d)
            hi_sl = lax.slice_in_dim(
                out, out.shape[d] - max(lo, 1), out.shape[d], axis=d
            )
            # receive from right neighbor (their low slab -> my high ghost)
            recv_hi = lax.ppermute(
                lo_sl, name, [((i + 1) % n, i) for i in range(n)]
            ) if hi > 0 else None
            # receive from left neighbor (their high slab -> my low ghost)
            recv_lo = lax.ppermute(
                hi_sl, name, [((i - 1) % n, i) for i in range(n)]
            ) if lo > 0 else None
            parts = []
            if lo > 0:
                ghost_lo = recv_lo if periodic else jnp.where(
                    (idx == 0),
                    jnp.zeros_like(recv_lo),
                    recv_lo,
                )
                parts.append(ghost_lo)
            parts.append(out)
            if hi > 0:
                ghost_hi = recv_hi if periodic else jnp.where(
                    (idx == n - 1),
                    jnp.zeros_like(recv_hi),
                    recv_hi,
                )
                parts.append(ghost_hi)
            out = jnp.concatenate(parts, axis=d)
        else:
            pad = [(0, 0)] * out.ndim
            pad[d] = (lo, hi)
            out = jnp.pad(out, pad, mode="wrap" if periodic else "constant")
    return out


def sharded_stencil(
    local_sweep: Callable,
    gmesh: GridMesh,
    halo: Sequence[tuple[int, int]],
    rank: int,
    periodic: bool = False,
):
    """Wrap a *local* sweep (operating on a halo-extended block and returning
    the un-extended local block) into a global sharded function.

    local_sweep(ext_block, block_info) -> local block
      block_info: dict with 'start' (per-dim global start row of this shard's
      block, traced) for boundary masking.
    periodic=True gives torus ghost semantics at the global domain edge
    (the ring ppermute wraps at the mesh boundary; unsharded dims pad with
    mode='wrap') — without it a torus operator's edge shards would see
    zero-filled ghosts.
    """
    spec = gmesh.pspec(rank)
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))

    def global_fn(u):
        def local_fn(u_loc):
            ext = halo_pad_local(u_loc, halo, names, periodic=periodic)
            starts = []
            for d in range(rank):
                nm = names[d]
                if nm:
                    starts.append(lax.axis_index(nm) * u_loc.shape[d])
                else:
                    starts.append(0)
            return local_sweep(ext, {"start": tuple(starts)})

        return shard_map(
            local_fn,
            mesh=gmesh.mesh,
            in_specs=(spec,),
            out_specs=spec,
            check_vma=False,
        )(u)

    return global_fn


def allreduce_sum(x, gmesh: GridMesh):
    """psum over every mesh axis (for solver reductions inside shard_map)."""
    def inner(v):
        for name in gmesh.axis_names:
            v = lax.psum(v, name)
        return v

    return inner(x)
