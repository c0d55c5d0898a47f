"""Pytree vector-space utilities for matrix-free solvers.

The reference's PETSc runtime works on flat `Vec` buffers packed from strided
memrefs (`lib/Runtime/PETSc/NeptunePETScRuntime.cpp:897-1426`). The JAX
equivalent keeps grid-shaped (and multi-field tuple) states as JAX pytrees and
performs vector-space algebra leaf-wise — XLA fuses these into the surrounding
solver iteration, and multi-field nonlinear states (the
`test/python_tests/test_swe_implicit.py` tuple-state API) come for free.

Reduction determinism: `tdot`/`tnorm` accumulate with jnp.vdot/jnp.sum per leaf
then sum leaves in fixed pytree order, so convergence behavior is bitwise
reproducible run-to-run on a fixed topology (the "bit-stable convergence"
target in BASELINE.md). Under `config.pinned_arithmetic` the reductions go
further: a fixed pairwise-halving tree over the flat vector makes them
bitwise identical across mesh SHAPES too (the compiler's reduction tiling —
and hence association order — otherwise depends on the local shard shape),
and the products feeding the tree (and `taxpy`'s `alpha*x`) are fenced with
`_fma_fence` so `mul` can never contract into a layout-dependent FMA.

FMA-fence design note: `lax.optimization_barrier`, `reduce_precision`, and
bitcast round-trips all FAIL to block contraction — XLA CPU strips/looks
through every one of them and the partitioner rematerializes the multiply
inside downstream add fusions (measured: 1-ulp layout-dependent drift in
`v[:m] + v[m:]` when one operand arrives via collective-permute and the
other's mul is fused+contracted). The only construct the whole pipeline
provably does not contract across is a `select` on a runtime predicate, so
the fence is `where(isfinite(v), v, nan)` — identity for finite data, and
non-finite data poisons to NaN (a dot/axpy touching inf would round-trip
through NaN anyway in any serious solve; documented deviation: ±inf
products yield NaN rather than ±inf under the pinned flag).
"""

from __future__ import annotations

import jax
import jax.flatten_util
import jax.numpy as jnp
from jax import tree_util as jtu

from ..config import config


def tmap(f, *trees):
    return jtu.tree_map(f, *trees)


def tadd(a, b):
    return jtu.tree_map(jnp.add, a, b)


def tsub(a, b):
    return jtu.tree_map(jnp.subtract, a, b)


def tscale(alpha, a):
    return jtu.tree_map(lambda x: alpha * x, a)


def _fma_fence(v):
    """Materialize `v`'s rounding so no consumer add can contract `v`'s
    producing multiply into an FMA (layout-dependent extra precision).

    `where` on a runtime predicate is the one construct XLA will not
    contract across (barriers/reduce_precision/bitcasts all get stripped or
    looked through — see module docstring). Identity for finite values;
    non-finite values poison to NaN.
    """
    return jnp.where(jnp.isfinite(v), v, jnp.asarray(jnp.nan, v.dtype))


def taxpy(alpha, x, y):
    """y + alpha * x, leaf-wise."""
    if config.pinned_arithmetic:
        return jtu.tree_map(lambda xi, yi: yi + _fma_fence(alpha * xi), x, y)
    return jtu.tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def tneg(a):
    return jtu.tree_map(jnp.negative, a)


def tzeros_like(a):
    return jtu.tree_map(jnp.zeros_like, a)


def _pairwise_sum(v: jnp.ndarray):
    """Sum a flat vector through a fixed pairwise-halving tree.

    The association order is a pure function of the GLOBAL element order
    (pad to a power of two, then log2(N) rounds of v[:m] + v[m:]), so the
    result is bitwise identical no matter how v is sharded — each round is
    an elementwise IEEE add whose per-element rounding cannot depend on
    tiling. This is what makes `pinned_arithmetic` dot products mesh-shape
    invariant; cost is log2(N) passes instead of the compiler's single
    fused reduction.
    """
    n = v.size
    if n == 0:
        return jnp.zeros((), v.dtype)
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        v = jnp.pad(v, (0, m - n))
    while m > 1:
        m //= 2
        v = v[:m] + v[m:]
    return v[0]


def tdot(a, b):
    """Sum of leaf-wise real inner products (fixed association order).

    Under `config.pinned_arithmetic` each leaf reduces through the fixed
    pairwise tree (`_pairwise_sum`), with the product fenced against FMA
    contraction — bitwise identical across mesh shapes.
    """
    leaves_a = jtu.tree_leaves(a)
    leaves_b = jtu.tree_leaves(b)
    acc = None
    pinned = config.pinned_arithmetic
    for x, y in zip(leaves_a, leaves_b):
        if pinned:
            p = _fma_fence(x.reshape(-1) * y.reshape(-1))
            d = _pairwise_sum(p)
        else:
            d = jnp.vdot(x, y)
        acc = d if acc is None else acc + d
    return acc


def tnorm(a):
    return jnp.sqrt(tdot(a, a))


def tsize(a) -> int:
    return sum(x.size for x in jtu.tree_leaves(a))


def ravel(a):
    """Flatten a pytree to a vector; returns (vec, unravel_fn)."""
    return jax.flatten_util.ravel_pytree(a)
