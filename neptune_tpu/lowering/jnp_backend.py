"""Pure-jnp apply/reduce execution — the reference dataflow lowering.

This is the rebuild of the reference's `neptune-ir-dataflow-lowering` CPU
path (`lib/Passes/DataflowLowering.cpp:258-448`): where the reference emits a
rank-deep `scf.for` nest with `memref.load` at `iv + offset − input_lb`, here
each `access` becomes a whole-array shift (`shift_read`) and the scalar body
is evaluated vectorized over the full logical domain — XLA fuses the shifts
and arithmetic into a single HBM-bandwidth-bound elementwise kernel.

Semantics reproduced exactly:
  * storage normalization — logical `[lb, ub)` to 0-based physical arrays
    (`DataflowLowering.cpp:41-104`);
  * copy-through boundary contract — the apply result is seeded with input0
    (zeros when no inputs) and only the `bounds` sub-domain is overwritten
    (`DataflowLowering.cpp:281-287`);
  * out-of-domain `access` reads are *unspecified* (they wrap here); programs
    must mask them with `select`, as the reference's boundary-residual kernels
    do with `scf.if` (`smoke_time_advance_nonlinear.mlir:37-80`).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..config import config
from ..ir.core import Block, Operation, Value
from ..ir.types import Bounds, ScalarType, TempType

_BINOPS = {
    "arith.add": jnp.add,
    "arith.sub": jnp.subtract,
    "arith.mul": jnp.multiply,
    "arith.div": jnp.divide,
    "arith.pow": jnp.power,
    "arith.min": jnp.minimum,
    "arith.max": jnp.maximum,
    "arith.and": jnp.logical_and,
    "arith.or": jnp.logical_or,
}

_UNARY = {
    "arith.neg": jnp.negative,
    "arith.not": jnp.logical_not,
    "math.exp": jnp.exp,
    "math.log": jnp.log,
    "math.sqrt": jnp.sqrt,
    "math.sin": jnp.sin,
    "math.cos": jnp.cos,
    "math.tan": jnp.tan,
    "math.tanh": jnp.tanh,
    "math.abs": jnp.abs,
    "math.erf": jax.scipy.special.erf,
}

_CMPS = {
    "eq": jnp.equal,
    "ne": jnp.not_equal,
    "lt": jnp.less,
    "le": jnp.less_equal,
    "gt": jnp.greater,
    "ge": jnp.greater_equal,
}


_DTYPE_BY_NAME = {
    "float64": jnp.float64,
    "float32": jnp.float32,
    "bfloat16": jnp.bfloat16,
    "index": jnp.int32,
    "int32": jnp.int32,
    "bool": jnp.bool_,
}


def _scalar_dtype(t: ScalarType):
    return _DTYPE_BY_NAME[t.name]


def _scalar_dtype_by_name(name: str):
    return _DTYPE_BY_NAME[name]


def shift_read(
    arr: jnp.ndarray, offset: Sequence[int], periodic=False
) -> jnp.ndarray:
    """view[i] = arr[i + offset].

    periodic (bool or per-dim sequence of bool): wrapped dims use torus-style
    jnp.roll; the rest zero-fill the out-of-range edge instead — those
    positions are unspecified by the apply contract (the copy-through mask
    discards them), and the static slice+pad fuses into the surrounding
    elementwise stencil.
    The sharded fused path wraps only UNSHARDED dims of periodic operators:
    sharded dims' local wrap would be globally wrong, so they zero-fill and
    the strip bands recompute their edge zones.
    """
    if all(o == 0 for o in offset):
        return arr
    if isinstance(periodic, bool):
        flags = (periodic,) * len(offset)
    else:
        flags = tuple(periodic)
    roll_shift = tuple(-o if f else 0 for o, f in zip(offset, flags))
    if any(roll_shift):
        arr = jnp.roll(
            arr, shift=roll_shift, axis=tuple(range(len(offset)))
        )
    if all(f or o == 0 for o, f in zip(offset, flags)):
        return arr
    slices, pads = [], []
    for d, (o, f) in enumerate(zip(offset, flags)):
        size = arr.shape[d]
        if f:
            o = 0
        o = max(-size, min(o, size))
        if o >= 0:
            slices.append(slice(o, size))
            pads.append((0, o))
        else:
            slices.append(slice(0, size + o))
            pads.append((-o, 0))
    return jnp.pad(arr[tuple(slices)], pads)


class _Aff:
    """Symbolic affine form `const + Σ coef_i · atom_i` built during DAG
    evaluation (affine folding, config.fold_affine). Coefficients and the
    constant are PYTHON floats — coefficient arithmetic happens exactly in
    f64 at trace time and rounds into the array dtype once at
    materialization, so the folded chain is never less accurate than the
    traced op sequence it replaces. Atoms are opaque block values (stencil
    accesses, scalar args, non-affine subgraph results)."""

    __slots__ = ("const", "terms", "tname")

    def __init__(self, const, terms, tname):
        self.const = const
        self.terms = terms  # dict: atom key -> python-float coefficient
        self.tname = tname  # ScalarType name, for pure-const materialization


_AFF_FLOATS = ("float64", "float32", "bfloat16")
_AFF_OPS = (
    "neptune.access", "arith.constant", "arith.neg",
    "arith.add", "arith.sub", "arith.mul", "arith.div",
)


def _aff_scale(a: _Aff, c: float, tname) -> _Aff:
    return _Aff(a.const * c, {k: v * c for k, v in a.terms.items()}, tname)


def _aff_addsub(a: _Aff, b: _Aff, sign: float, tname) -> _Aff:
    terms = dict(a.terms)
    for k, v in b.terms.items():
        terms[k] = terms.get(k, 0.0) + sign * v
    return _Aff(a.const + sign * b.const, terms, tname)


def eval_scalar_dag(
    body: Block,
    rank: int,
    num_inputs: int,
    access_fn,
    index_fn,
    scalar_args: Sequence,
    pinned: bool | None = None,
) -> list:
    """Evaluate an apply region's scalar DAG vectorized, with pluggable
    access/index resolution (shared by the whole-array and shard_map
    lowerings).

    access_fn(input_index, offset) -> array of the accessed neighbor values
    index_fn(dim) -> array of logical coordinates along `dim`
    pinned: apply the reproducibility FMA fence to apply-body multiplies.
    None (the jnp/GSPMD path) follows `config.pinned_arithmetic`; the
    shard_map fused callers pass False — they are performance paths and
    keep default arithmetic by design (`config.py`).
    """
    if pinned is None:
        pinned = config.pinned_arithmetic
    fold = config.fold_affine and not pinned
    env: dict[int, object] = {}
    arg_of_input: dict[int, int] = {}

    for k in range(num_inputs):
        arg_of_input[body.args[rank + k].uid] = k
    for k, s in enumerate(scalar_args):
        env[body.args[rank + num_inputs + k].uid] = s
    for d in range(rank):
        env[body.args[d].uid] = None  # resolved lazily via index_fn

    index_cache: dict[int, object] = {}

    def index_value(d):
        if d not in index_cache:
            index_cache[d] = index_fn(d)
        return index_cache[d]

    # ---- affine folding (config.fold_affine) ------------------------------
    atoms: dict[object, object] = {}  # atom key -> opaque block value

    def materialize(a: _Aff):
        coefs = list(a.terms.values())
        acc = None
        if len(coefs) > 1 and all(c == coefs[0] for c in coefs):
            # common-coefficient factoring: Σ c·x_i = c·Σ x_i keeps e.g. the
            # 5-pt Jacobi at its hand-written 4-op form instead of 4 FMAs
            for k in a.terms:
                v = atoms[k]
                acc = v if acc is None else acc + v
            c = coefs[0]
            if c == -1.0:
                acc = -acc
            elif c != 1.0:
                acc = acc * c
        else:
            for k, c in a.terms.items():
                v = atoms[k]
                t = v if c == 1.0 else (-v if c == -1.0 else c * v)
                acc = t if acc is None else acc + t
        if acc is None:
            return jnp.asarray(a.const, _scalar_dtype_by_name(a.tname))
        if a.const != 0.0:
            acc = acc + a.const
        return acc

    def as_aff(o):
        """The operand's affine view: an existing _Aff, or its opaque value
        wrapped as a single atom. None for lazily-resolved index args."""
        if o.block_arg_of is body and o.index < rank:
            return None
        val = env[o.uid]
        if isinstance(val, _Aff):
            return val
        key = ("v", o.uid)
        if key not in atoms:
            atoms[key] = val
        return _Aff(0.0, {key: 1.0}, None)

    def try_fold(op) -> bool:
        """Fold one affine op symbolically; False -> take the eager path."""
        tname = op.results[0].type.name
        if tname not in _AFF_FLOATS:
            return False
        name = op.name
        if name == "neptune.access":
            k = arg_of_input[op.operands[0].uid]
            key = ("a", k, tuple(op.attrs["offset"]))
            if key not in atoms:  # dedups repeated accesses as a side effect
                atoms[key] = access_fn(k, op.attrs["offset"])
            env[op.results[0].uid] = _Aff(0.0, {key: 1.0}, tname)
            return True
        if name == "arith.constant":
            env[op.results[0].uid] = _Aff(float(op.attrs["value"]), {}, tname)
            return True
        if name == "arith.neg":
            a = as_aff(op.operands[0])
            if a is None:
                return False
            env[op.results[0].uid] = _aff_scale(a, -1.0, tname)
            return True
        a, b = (as_aff(o) for o in op.operands)
        if a is None or b is None:
            return False
        if name == "arith.add" or name == "arith.sub":
            sign = 1.0 if name == "arith.add" else -1.0
            env[op.results[0].uid] = _aff_addsub(a, b, sign, tname)
            return True
        if name == "arith.mul":
            if not a.terms:
                env[op.results[0].uid] = _aff_scale(b, a.const, tname)
                return True
            if not b.terms:
                env[op.results[0].uid] = _aff_scale(a, b.const, tname)
                return True
            return False  # field*field: materialize both, evaluate eagerly
        if name == "arith.div":
            if not b.terms and b.const != 0.0:
                env[op.results[0].uid] = _aff_scale(a, 1.0 / b.const, tname)
                return True
            return False
        return False

    def lookup(v):
        if v.block_arg_of is body and v.index < rank:
            return index_value(v.index)
        val = env[v.uid]
        if isinstance(val, _Aff):
            val = materialize(val)
            env[v.uid] = val
        return val

    yielded = None
    for op in body.ops:
        if fold and op.name in _AFF_OPS and op.results and try_fold(op):
            continue
        if op.name == "neptune.access":
            k = arg_of_input[op.operands[0].uid]
            env[op.results[0].uid] = access_fn(k, op.attrs["offset"])
        elif op.name == "arith.constant":
            dt = _scalar_dtype(op.results[0].type)
            env[op.results[0].uid] = jnp.asarray(op.attrs["value"], dt)
        elif op.name in _BINOPS:
            a, b = (lookup(o) for o in op.operands)
            if op.name == "arith.div" and op.results[0].type.name in (
                "index", "int32"
            ):
                # integer-typed division truncates toward zero (C / MLIR
                # arith.divsi semantics — the native backend emits long
                # division); jnp.divide would true-divide to float
                r = jax.lax.div(
                    jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32)
                )
            else:
                r = _BINOPS[op.name](a, b)
            if op.name == "arith.mul" and pinned:
                # reproducibility fence: keep the product out of any FMA —
                # contraction placement depends on the local tile shape,
                # which is what breaks cross-mesh-shape bitwise identity.
                # Must be the select-based fence: optimization_barrier /
                # reduce_precision / bitcast are all stripped or looked
                # through by XLA (measured — see utils/tree.py's design
                # note), leaving the multiply contractable after all.
                from ..utils.tree import _fma_fence

                r = _fma_fence(r)
            env[op.results[0].uid] = r
        elif op.name in _UNARY:
            env[op.results[0].uid] = _UNARY[op.name](lookup(op.operands[0]))
        elif op.name == "arith.cmp":
            a, b = (lookup(o) for o in op.operands)
            env[op.results[0].uid] = _CMPS[op.attrs["pred"]](a, b)
        elif op.name == "arith.select":
            c, a, b = (lookup(o) for o in op.operands)
            env[op.results[0].uid] = jnp.where(c, a, b)
        elif op.name == "arith.cast":
            dt = _scalar_dtype(op.results[0].type)
            v = lookup(op.operands[0])
            env[op.results[0].uid] = (
                v.astype(dt) if hasattr(v, "astype") else jnp.asarray(v, dt)
            )
        elif op.name == "neptune.yield":
            yielded = [lookup(o) for o in op.operands]
        else:
            raise NotImplementedError(f"scalar op {op.name} in apply body")

    assert yielded is not None, "apply body did not yield"
    return yielded


def eval_apply_body(
    body: Block,
    rank: int,
    num_inputs: int,
    out_type: TempType,
    input_arrays: Sequence[jnp.ndarray],
    scalar_args: Sequence,
    input_lbs: Sequence[tuple] = (),
    periodic: bool = False,
) -> list[jnp.ndarray]:
    """Vectorized whole-domain evaluation (the jnp backend's hooks).

    input_lbs: logical lower bound per input temp; an input whose lb differs
    from the output's reads at a shifted physical position (storage
    normalization: physical = logical − lb, ir/types.py).
    """
    shape = out_type.bounds.shape
    lb = out_type.bounds.lb

    def access_fn(k, offset):
        in_lb = input_lbs[k] if k < len(input_lbs) else lb
        adj = tuple(o + (lo - li) for o, lo, li in zip(offset, lb, in_lb))
        return shift_read(input_arrays[k], adj, periodic)

    def index_fn(d):
        return jax.lax.broadcasted_iota(jnp.int32, shape, d) + lb[d]

    yielded = eval_scalar_dag(
        body, rank, num_inputs, access_fn, index_fn, scalar_args
    )
    out_dtype = jnp.dtype(out_type.element)
    return [jnp.broadcast_to(jnp.asarray(y, out_dtype), shape) for y in yielded]


def box_mask(shape, lo, hi) -> jnp.ndarray:
    """Boolean mask of the box [lo, hi) in an array of `shape`, built from
    iota compares. A grid-sized NumPy mask would instead become an HLO
    constant per use (64 MB at 8192^2), which XLA stores and constant-folds
    through whatever consumes it."""
    m = None
    for d in range(len(shape)):
        iv = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), d)
        c = (iv >= lo[d]) & (iv < hi[d])
        m = c if m is None else m & c
    return m


def interior_mask(bounds: Bounds, outer: Bounds) -> jnp.ndarray:
    """Mask selecting `bounds` inside `outer`'s physical array.

    The masked `jnp.where` composition is used instead of
    `.at[slices].set(...)` for the copy-through write: the select fuses
    into the stencil's elementwise kernel (no scatter), and it sidesteps an
    XLA:CPU miscompilation where a dynamic-update-slice whose source aliases
    the updated operand produces wrong values inside nested fori_loop bodies
    (observed jax 0.9.0: GMRES Arnoldi vectors corrupted when the operator
    ended in x.at[sl].set(...)).
    """
    lo = tuple(b - o for b, o in zip(bounds.lb, outer.lb))
    hi = tuple(b - o for b, o in zip(bounds.ub, outer.lb))
    return box_mask(outer.shape, lo, hi)


def execute_apply(op: Operation, operand_arrays: Sequence):
    """Full apply semantics: seed + interior overwrite. Returns a single
    array, or a tuple for multi-result applies (output j seeds copy-through
    from input j when it exists, zeros otherwise)."""
    out_type: TempType = op.results[0].type
    n_in = op.attrs.get("num_inputs", len(op.operands))
    inputs = operand_arrays[:n_in]
    scalars = operand_arrays[n_in:]
    bounds: Bounds = op.attrs["bounds"]
    rank = out_type.bounds.rank

    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    computed = eval_apply_body(
        op.region(0),
        rank,
        n_in,
        out_type,
        inputs,
        scalars,
        input_lbs,
        periodic=bool(op.attrs.get("periodic")),
    )

    outs = []
    for j, c in enumerate(computed):
        if bounds == out_type.bounds:
            outs.append(c)
            continue
        seed = (
            jnp.asarray(inputs[j], jnp.dtype(out_type.element))
            if j < n_in
            else jnp.zeros(out_type.bounds.shape, jnp.dtype(out_type.element))
        )
        mask = interior_mask(bounds, out_type.bounds)
        outs.append(jnp.where(mask, c, seed))
    return outs[0] if len(outs) == 1 else tuple(outs)


def execute_reduce(op: Operation, arr: jnp.ndarray):
    """All five reduce kinds (the reference documents five but implements only
    "sum", `DataflowLowering.cpp:652-654`)."""
    tt: TempType = op.operands[0].type
    bounds = op.attrs.get("bounds")
    if bounds is not None:
        arr = arr[bounds.rel_slices(tt.bounds)]
    kind = op.attrs["kind"]
    if kind == "sum":
        return jnp.sum(arr)
    if kind == "max":
        return jnp.max(arr)
    if kind == "min":
        return jnp.min(arr)
    if kind == "l1":
        return jnp.sum(jnp.abs(arr))
    if kind == "l2":
        return jnp.sqrt(jnp.sum(arr * arr))
    raise ValueError(f"unknown reduce kind {kind!r}")
