"""Preconditioners for the matrix-free Krylov solvers.

The reference defaults to no preconditioning (PCNONE,
`NeptunePETScRuntime.cpp:146-149`); BASELINE.md asks this build to provide
Jacobi and SSOR. Matrix-free Jacobi needs the operator diagonal, which we
extract exactly by **stencil-period probing**: for a stencil whose offsets o
satisfy |o_d| <= w_d, probe vectors that are 1 on the lattice
{ i : i ≡ c (mod w_d+1) } and 0 elsewhere have the property that distinct
points in one probe never interact through the stencil, so
diag = Σ_probes probe ⊙ A(probe). The number of operator applications is
Π_d (w_d + 1) — e.g. 4 for a 2-D 5-point Laplacian — independent of grid size.
The needed halo widths come from the verifier's reach analysis
(`neptune_tpu.ir.verify`, reference analog `VerifyAndAnnotate.cpp:252-266`).
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsp
import numpy as np


def extract_diagonal(
    matvec: Callable,
    like: jnp.ndarray,
    halo: Sequence[tuple[int, int]],
):
    """Exact operator diagonal via stencil-period probing.

    `like` is a zero template with the operator's grid shape/dtype; `halo` is
    the per-dim (lo, hi) reach of the operator (so any nonzero A_ij has
    |j_d - i_d| <= max(lo_d, hi_d)).
    """
    shape = like.shape
    if not halo:
        raise ValueError(
            "operator halo metadata missing (empty halo): run "
            "verify_and_annotate on the module before building a Jacobi "
            "preconditioner — probing with an unknown stencil reach would "
            "silently return row sums instead of the diagonal"
        )
    periods = [max(lo, hi) + 1 for lo, hi in halo]
    if len(periods) != len(shape):
        periods = [max(periods)] * len(shape)

    # Probe masks from iota, not NumPy: a grid-sized NumPy mask becomes an
    # HLO constant that XLA then constant-folds through the operator at
    # compile time (minutes at 8192^2).
    grids = [jax.lax.broadcasted_iota(jnp.int32, shape, d) for d in range(len(shape))]
    diag = jnp.zeros_like(like)
    for combo in itertools.product(*[range(p) for p in periods]):
        hit = None
        for g, c, p in zip(grids, combo, periods):
            m = (g % p) == c
            hit = m if hit is None else hit & m
        probe = hit.astype(like.dtype)
        diag = diag + probe * matvec(probe)
    return diag


def safe_inv_diag(d: jnp.ndarray) -> jnp.ndarray:
    """1/d with zero entries mapped to 1 (identity on those points)."""
    return jnp.where(d == 0, jnp.ones_like(d), 1.0 / jnp.where(d == 0, 1.0, d))


def jacobi(matvec: Callable, like: jnp.ndarray, halo) -> Callable:
    """M(x) = x / diag(A), with zero-diagonal entries passed through
    unpreconditioned (identity on those points — keeps boundary copy-through
    rows, which have diag from the identity part, well-defined)."""
    inv = safe_inv_diag(extract_diagonal(matvec, like, halo))

    def M(x):
        return x * inv

    return M


def _red_mask_np(shape) -> np.ndarray:
    """Checkerboard parity mask (host-precomputed, constant under jit)."""
    s = np.zeros(shape, np.int64)
    for d, n in enumerate(shape):
        s = s + np.arange(n).reshape((1,) * d + (-1,) + (1,) * (len(shape) - d - 1))
    return (s % 2) == 0


def ssor_stencil(
    matvec: Callable, like: jnp.ndarray, halo, omega: float = 1.0
) -> Callable:
    """Matrix-free red-black SSOR: M^{-1} r applied with two operator
    sweeps and the probed diagonal — no assembled matrix at any size
    (the round-3 `ssor_dense` capped SSOR at toy grids; BASELINE's north
    star names "Jacobi/SSOR preconditioners that apply the same stencil
    operators", and this is that). Reference analog: PETSc's
    `-pc_type sor -pc_sor_symmetric` reachable through the options DB
    (`NeptunePETScRuntime.cpp:139-150`).

    Factorization (matching `ssor_dense` exactly at every omega):
        M^{-1} = ω(2-ω) (D/ω + U)^{-1} D (D/ω + L)^{-1}
    computed as a = (D/ω + L)^{-1} r (red rows direct, black rows see
    red), y = D a, z = (D/ω + U)^{-1} y (black rows direct, red rows
    see black), result ω(2-ω)·z — all triangular solves exact under the
    red/black ordering because star stencils have no same-color coupling.
    Stencils WITH same-color couplings (e.g. reach-2 offsets like (2,0))
    have those couplings dropped from L/U — the preconditioner is then
    SSOR of the odd-parity part plus the diagonal: still symmetric
    positive definite (valid for CG), just a weaker smoother.

    Cost: 2 matvecs per application (the off-diagonal products), vs 0 for
    Jacobi — worth it when the iteration-count reduction beats 3x work
    per iteration (measured on 512² Poisson f32: see bench `ssor` row).
    """
    diag = extract_diagonal(matvec, like, halo)
    dsafe = jnp.where(diag == 0, jnp.ones_like(diag), diag)
    inv = safe_inv_diag(diag)
    red = jnp.asarray(_red_mask_np(like.shape))
    scale = omega * (2.0 - omega)

    def offdiag(z):
        return matvec(z) - diag * z

    def M(r):
        # forward (D/ω + L)^{-1}: red rows have no L coupling (all L
        # entries are black<-red), black rows subtract the red sweep
        a = jnp.where(red, omega * inv * r, jnp.zeros_like(r))
        a = jnp.where(red, a, omega * inv * (r - offdiag(a)))
        y = dsafe * a
        # backward (D/ω + U)^{-1}: black rows direct, red rows see black
        z = jnp.where(red, jnp.zeros_like(r), omega * inv * y)
        z = jnp.where(red, omega * inv * (y - offdiag(z)), z)
        return scale * z

    return M


def ssor_dense(A: jnp.ndarray, omega: float = 1.0) -> Callable:
    """SSOR preconditioner from an assembled dense matrix:
    M^{-1} = ω(2-ω) (D/ω + U)^{-1} D (D/ω + L)^{-1}.
    Available on the assembled-matrix path (the analog of the reference's
    DenseRM mode, `NeptunePETScRuntime.cpp:241-252`)."""
    from ..utils.tree import ravel

    D = jnp.diag(A)
    Dsafe = jnp.where(D == 0, jnp.ones_like(D), D)
    L = jnp.tril(A, -1)
    U = jnp.triu(A, 1)
    lower = jnp.diag(Dsafe / omega) + L
    upper = jnp.diag(Dsafe / omega) + U
    scale = omega * (2.0 - omega)

    def M(r):
        flat, unravel = ravel(r)
        y = jsp.solve_triangular(lower, flat, lower=True)
        y = Dsafe * y
        z = jsp.solve_triangular(upper, y, lower=False)
        return unravel(scale * z)

    return M


def make_preconditioner(
    name: str,
    matvec: Callable,
    like,
    halo=(),
    dense_matrix=None,
    omega: float = 1.0,
):
    """Preconditioner factory keyed by the `precond` op attribute.

    "ssor" is matrix-free (red-black sweeps through the operator itself);
    "ssor_dense" keeps the assembled-triangular-solve variant for small
    systems and as the exactness oracle. "mg" is built by the callers that
    own an operator hierarchy (executor / dsl), not here.
    """
    if name in (None, "none"):
        return None
    if name == "jacobi":
        return jacobi(matvec, like, halo)
    if name == "ssor":
        return ssor_stencil(matvec, like, halo, omega=omega)
    if name == "ssor_dense":
        if dense_matrix is None:
            raise ValueError(
                "ssor_dense preconditioner requires an assembled matrix"
            )
        return ssor_dense(dense_matrix, omega=omega)
    raise ValueError(f"unknown preconditioner {name!r}")
