"""Operator handles — the `assemble_matrix` result object.

The reference's `_neptune_rt_runtime_assemble_matrix` allocates a lazy handle
{keyHash, symName, KSP ctx} disguised as a `memref<?x?xf64>`
(`NeptunePETScRuntime.cpp:575-596,614-631`); `solve_linear` later dlsyms the
compiled operator by name and runs matrix-free KSP through a MatShell
(`:719-786`). Here the handle holds the traced matvec callable directly
(closed over at trace time — the JAX answer to runtime dlsym; see SURVEY.md §7
hard part (d)) plus the structural metadata (structure-key hash, halo) that the
reference threads through keyHash, and offers *actual* dense assembly as an
explicit opt-in for small systems / SSOR / tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ir.types import TempType


@dataclass
class MatrixHandle:
    """Lazy linear-operator handle over a grid-shaped vector space."""

    symbol: str
    matvec: Callable  # grid-shaped array -> grid-shaped array
    temp_type: TempType  # operand/result temp type (grid shape, dtype)
    structure_key_hash: int = 0
    halo: tuple = ()  # per-dim (lo, hi) reach, for diagonal probing
    # interior apply bounds of a SINGLE-apply opdef whose out-of-interior
    # rows are exact copy-through ((A z)_ring = z_ring): enables the
    # Dirichlet-lift solve below. None for composite/unknown structure.
    interior: Optional[object] = None
    _dense_cache: Optional[jnp.ndarray] = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.temp_type.bounds.size

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return self.temp_type.bounds.shape

    @property
    def dtype(self):
        return jnp.dtype(self.temp_type.element)

    def __call__(self, x):
        return self.matvec(x)

    def dense(self) -> jnp.ndarray:
        """Materialize the full n×n matrix by applying the operator to the
        identity basis (vmapped, so it is one big batched stencil sweep).
        A[:, j] = A e_j, flattened in C order of the grid."""
        if self._dense_cache is None:
            n = self.n
            eye = jnp.eye(n, dtype=self.dtype)
            cols = jax.vmap(lambda e: self.matvec(e.reshape(self.grid_shape)).ravel())(
                eye
            )
            self._dense_cache = cols.T
        return self._dense_cache

    def ring_lift(self, b):
        """Dirichlet lift for the copy-through ring, or None when the
        structure is unknown / the operator is full-domain.

        The copy-through contract makes the system nonsymmetric at the
        boundary ring (interior rows read ring values, ring rows are
        identity). Unpreconditioned CG tolerates it, but a non-uniform
        preconditioner (Jacobi/SSOR: ring diag 1 vs interior diag) breaks
        the M-symmetry CG needs and stalls ~5 digits short at tight
        tolerances when b carries nonzero ring data (measured: 32² Poisson
        f64 tol 1e-10, CG+Jacobi plateaued at 1e-8 after 4000 iterations;
        108 iterations with the lift). The fix is exact and costs ONE
        matvec: with lift = b masked to the ring,

            solve A x_int = b - A·lift   (rhs ring = 0 -> the iterates
                                          never leave the symmetric
                                          interior subspace)
            x = x_int + lift.
        """
        if self.interior is None:
            return None
        outer = self.temp_type.bounds
        if self.interior == outer:
            return None
        from ..lowering.jnp_backend import interior_mask

        inner = interior_mask(self.interior, outer)
        return jnp.where(inner, jnp.zeros_like(b), b)

    def diagonal(self) -> jnp.ndarray:
        """Exact diagonal via stencil-period probing (see solvers.precond)."""
        from .precond import extract_diagonal

        like = jnp.zeros(self.grid_shape, self.dtype)
        halo = self.halo or tuple((1, 1) for _ in self.grid_shape)
        return extract_diagonal(self.matvec, like, halo)
