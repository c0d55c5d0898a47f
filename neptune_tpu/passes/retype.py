"""Module retyping: swap the element dtype of every grid type.

Enables mixed-precision execution (SURVEY.md §7 hard part (e): f64 is
slower than f32 on most accelerators). The
iterative-refinement solver (`solvers.refine`) runs the *same operator* at
float32 for the inner Krylov solves and float64 for residual evaluation —
this pass produces the low-precision twin of a module.

Note constants keep their values (a f64 literal rounds to f32 at execution);
index/bool scalars are untouched.
"""

from __future__ import annotations

from ..ir.core import Module
from ..ir.types import (
    FieldType,
    MatrixType,
    ScalarType,
    TempType,
    TensorType,
)

_FLOATS = {"float64", "float32", "bfloat16"}


def _swap(t, elem: str):
    if isinstance(t, TempType) and t.element in _FLOATS:
        return TempType(elem, t.bounds, t.location)
    if isinstance(t, FieldType) and t.element in _FLOATS:
        return FieldType(elem, t.bounds, t.location)
    if isinstance(t, TensorType) and t.element in _FLOATS:
        return TensorType(elem, t.shape)
    if isinstance(t, MatrixType) and t.element in _FLOATS:
        return MatrixType(elem, t.n)
    if isinstance(t, ScalarType) and t.name in _FLOATS:
        return ScalarType(elem)
    return t


def retype_module(module: Module, elem: str = "float32") -> Module:
    """Deep-copied module with every float grid/scalar type set to `elem`."""
    m = module.clone()
    from ..ir.types import FunctionType

    for fn in m.functions.values():
        fn.ftype = FunctionType(
            tuple(_swap(t, elem) for t in fn.ftype.inputs),
            tuple(_swap(t, elem) for t in fn.ftype.results),
        )
        # op attrs (bounds/shapes) are dtype-free; only value types change
        for op in fn.walk():
            for r in op.results:
                r.type = _swap(r.type, elem)
        for blk_args in _all_block_args(fn):
            blk_args.type = _swap(blk_args.type, elem)
    return m


def _all_block_args(fn):
    for a in fn.body.args:
        yield a
    for op in fn.walk():
        for region in op.regions:
            for a in region.args:
                yield a
