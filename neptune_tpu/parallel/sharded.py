"""GSPMD execution of compiled modules over a GridMesh.

The default multi-chip path: shard field arrays along leading grid dims, jit
the (unchanged) executor function with sharding annotations, and let XLA's
partitioner insert halo collective-permutes for the stencil shifts and
all-reduces for the solver dot products. Krylov/Newton loops work unchanged
because every reduction goes through `utils.tree.tdot` (jnp.vdot -> psum under
GSPMD) and every elementwise op shards trivially.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax

from ..lowering.executor import CompiledModule
from .mesh import GridMesh


def sharded_function(
    cm: CompiledModule,
    name: str,
    gmesh: GridMesh,
    arg_ranks: Optional[Sequence[Optional[int]]] = None,
) -> Callable:
    """jit a compiled function with mesh shardings on its grid args/results.

    arg_ranks: rank of each grid argument (None entries = replicated scalar);
    inferred from the function signature when omitted.
    """
    fn = cm.function(name)
    irfn = cm.module.lookup(name)
    if arg_ranks is None:
        arg_ranks = []
        for a in irfn.body.args:
            bounds = getattr(a.type, "bounds", None)
            if bounds is not None:
                arg_ranks.append(bounds.rank)
            elif hasattr(a.type, "shape"):
                arg_ranks.append(len(a.type.shape))
            else:
                arg_ranks.append(None)

    in_shardings = tuple(
        gmesh.sharding(r) if r else gmesh.replicated() for r in arg_ranks
    )

    out_ranks = []
    for t in irfn.ftype.results:
        bounds = getattr(t, "bounds", None)
        if bounds is not None:
            out_ranks.append(bounds.rank)
        elif hasattr(t, "shape"):
            out_ranks.append(len(t.shape))
        else:
            out_ranks.append(None)
    out_shardings = tuple(
        gmesh.sharding(r) if r else gmesh.replicated() for r in out_ranks
    )
    if len(out_shardings) == 1:
        out_shardings = out_shardings[0]

    return jax.jit(fn, in_shardings=in_shardings, out_shardings=out_shardings)


def sharded_opdef(cm: CompiledModule, name: str, gmesh: GridMesh) -> Callable:
    """jit an opdef's matvec with mesh shardings (for distributed Krylov)."""
    fn = cm.opdef(name)
    irfn = cm.module.lookup(name)
    ranks = [t.bounds.rank for t in irfn.ftype.inputs]
    in_shardings = tuple(gmesh.sharding(r) for r in ranks)
    out_ranks = [t.bounds.rank for t in irfn.ftype.results]
    out_shardings = tuple(gmesh.sharding(r) for r in out_ranks)
    if len(out_shardings) == 1:
        out_shardings = out_shardings[0]
    return jax.jit(fn, in_shardings=in_shardings, out_shardings=out_shardings)
