"""Verification + annotation pass.

Rebuild of the reference's `neptune-ir-verify-annotate` pass
(`lib/Passes/VerifyAndAnnotate.cpp`, pass def `include/Passes/NeptuneIRPasses.td:6-13`):

  1. module-level contract checks beyond build-time op checks — opdef signature
     `(Temp...) -> (Temp...)`, terminator arity/types, apply-region shape
     (`VerifyAndAnnotate.cpp:57-135`);
  2. the **linear-body whitelist** for `linear_opdef` bodies: access, constants,
     add/sub/neg/cast, and mul/div only with a constant-derived factor
     (div: constant rhs only) (`VerifyAndAnnotate.cpp:167-201`);
  3. **structure keys**: a canonical string of kind/signature/bounds/shapes/
     sorted access offsets (plus scalar op names for nonlinear opdefs) and a
     64-bit hash, attached to every opdef (`VerifyAndAnnotate.cpp:228-294`,
     which uses MD5 low 64 bits; we use blake2b) — these key the kernel cache;
  4. symbol-resolution checks (`VerifyAndAnnotate.cpp:375-384`).

New in this build (feeds sharding):
  5. **reach analysis**: per-opdef effective stencil shape obtained by Minkowski
     composition of apply shapes through the dataflow, attached as
     ``total_shape``; its per-dim halo widths drive shard_map halo exchange.
"""

from __future__ import annotations

import hashlib

from .core import Block, Function, Module, Operation, Value
from .ops import IRError, SCALAR_OPS
from .types import INDEX, ScalarType, StencilShape, TempType


def _err(msg: str):
    raise IRError(msg)


# --------------------------------------------------------------------------
# 1. structural contracts
# --------------------------------------------------------------------------


def _verify_opdef_common(fn: Function):
    """Signature + terminator contract (`VerifyAndAnnotate.cpp:62-95`);
    trailing scalar inputs (lifted scalar captures) are permitted."""
    seen_scalar = False
    for t in fn.ftype.inputs:
        if isinstance(t, ScalarType):
            seen_scalar = True
        elif not isinstance(t, TempType) or seen_scalar:
            _err(
                f"@{fn.name}: opdef inputs must be temps then trailing "
                f"scalars, got {t}"
            )
    for t in fn.ftype.results:
        if not isinstance(t, TempType):
            _err(f"@{fn.name}: opdef results must be temps, got {t}")
    term = fn.body.terminator
    if term is None or term.name != "neptune.return":
        _err(f"@{fn.name}: opdef body must end with neptune.return")
    if len(term.operands) != len(fn.ftype.results):
        _err(
            f"@{fn.name}: return arity {len(term.operands)} != "
            f"result count {len(fn.ftype.results)}"
        )
    for v, t in zip(term.operands, fn.ftype.results):
        if v.type != t:
            _err(f"@{fn.name}: return type {v.type} != declared {t}")


def _verify_apply_region(op: Operation):
    """Apply region contract: rank index args + one arg per temp input + one
    arg per scalar param; yield type matches result element
    (`VerifyAndAnnotate.cpp:96-138`)."""
    body = op.region(0)
    rtype: TempType = op.results[0].type
    rank = rtype.bounds.rank
    n_ops = len(op.operands)
    if len(body.args) != rank + n_ops:
        _err(
            f"apply region has {len(body.args)} args, expected {rank} index "
            f"+ {n_ops} operands"
        )
    for d in range(rank):
        if body.args[d].type != INDEX:
            _err(f"apply region arg {d} must be index, got {body.args[d].type}")
    n_in = op.attrs.get("num_inputs", n_ops)
    for k in range(n_ops):
        a = body.args[rank + k]
        if a.type != op.operands[k].type:
            _err(
                f"apply region operand arg {k} type {a.type} != operand "
                f"{op.operands[k].type}"
            )
        if k < n_in and not isinstance(op.operands[k].type, TempType):
            _err(f"apply input {k} must be a temp, got {op.operands[k].type}")
        if k >= n_in and not isinstance(op.operands[k].type, ScalarType):
            _err(f"apply scalar param {k - n_in} must be scalar")
    term = body.terminator
    if term is None or term.name != "neptune.yield":
        _err("apply region must terminate with neptune.yield")
    if len(term.operands) != len(op.results):
        _err(
            f"apply yields {len(term.operands)} values for {len(op.results)} results"
        )
    for yv, res in zip(term.operands, op.results):
        y = yv.type
        if not (isinstance(y, ScalarType) and y.name == res.type.element):
            _err(f"apply yield type {y} != result element {res.type.element}")


# --------------------------------------------------------------------------
# 2. linearity whitelist
# --------------------------------------------------------------------------

_COEFF_MATH = (
    "math.exp",
    "math.log",
    "math.sqrt",
    "math.sin",
    "math.cos",
    "math.tan",
    "math.tanh",
    "math.abs",
    "math.erf",
)


def _verify_linear_body(fn: Function):
    """Linearity analysis for `linear_opdef` bodies.

    Generalizes the reference's constant-only whitelist
    (`VerifyAndAnnotate.cpp:167-201`: access + const + add/sub/neg/cast +
    mul/div-by-constant) to a two-class dataflow:

      * **coefficient** — u-independent: constants, index IVs, and any scalar
        math over them (admits variable-coefficient operators like
        Black–Scholes' `sigma^2 S_i^2` terms, which are linear in u);
      * **linear** — (affine-)degree ≤ 1 in u: accesses, sums/differences,
        coefficient·linear products, linear/coefficient quotients, and
        selects with a coefficient condition (boundary-conditioned linear
        operators).

    linear·linear, division by linear, comparisons on linear values, and
    nonlinear math of linear values are rejected. (Like the reference, an
    added coefficient yields an *affine* operator; callers treat the result
    as the operator's action.)
    """
    for op in fn.body.ops:
        if op.name not in ("neptune.apply", "neptune.apply_linear", "neptune.return"):
            _err(
                f"@{fn.name}: op {op.name} not allowed in linear_opdef body "
                "(linearity whitelist)"
            )
    for apply_op in fn.body.ops:
        if apply_op.name != "neptune.apply":
            continue
        body = apply_op.region(0)
        rank = apply_op.results[0].type.bounds.rank
        n_in = apply_op.attrs.get("num_inputs", len(apply_op.operands))
        coeff: set[int] = set()
        # index IVs and scalar params are u-independent coefficients
        for d in range(rank):
            coeff.add(body.args[d].uid)
        for k in range(n_in, len(apply_op.operands)):
            coeff.add(body.args[rank + k].uid)

        def is_coeff(v) -> bool:
            return v.uid in coeff

        for op in body.ops:
            nm = op.name
            if nm == "arith.constant":
                coeff.add(op.results[0].uid)
            elif nm == "neptune.access":
                pass  # linear
            elif nm in ("arith.add", "arith.sub"):
                if all(is_coeff(o) for o in op.operands):
                    coeff.add(op.results[0].uid)
            elif nm == "arith.mul":
                a, b = op.operands
                if is_coeff(a) and is_coeff(b):
                    coeff.add(op.results[0].uid)
                elif not (is_coeff(a) or is_coeff(b)):
                    _err(
                        f"@{fn.name}: mul of two u-dependent values breaks "
                        "linearity (one factor must be a coefficient)"
                    )
            elif nm == "arith.div":
                a, b = op.operands
                if not is_coeff(b):
                    _err(
                        f"@{fn.name}: div with u-dependent divisor breaks "
                        "linearity (divisor must be a coefficient)"
                    )
                if is_coeff(a):
                    coeff.add(op.results[0].uid)
            elif nm in ("arith.neg", "arith.cast"):
                if is_coeff(op.operands[0]):
                    coeff.add(op.results[0].uid)
            elif nm in ("arith.cmp", "arith.min", "arith.max", "arith.pow") or nm in (
                "arith.and",
                "arith.or",
                "arith.not",
            ):
                if not all(is_coeff(o) for o in op.operands):
                    _err(
                        f"@{fn.name}: {nm} of u-dependent values breaks "
                        "linearity (coefficients only)"
                    )
                coeff.add(op.results[0].uid)
            elif nm in _COEFF_MATH:
                if not is_coeff(op.operands[0]):
                    _err(
                        f"@{fn.name}: {nm} of a u-dependent value breaks "
                        "linearity (nonlinear math on coefficients only)"
                    )
                coeff.add(op.results[0].uid)
            elif nm == "arith.select":
                c, a, b = op.operands
                if not is_coeff(c):
                    _err(
                        f"@{fn.name}: select with u-dependent condition breaks "
                        "linearity (condition must be a coefficient)"
                    )
                if is_coeff(a) and is_coeff(b):
                    coeff.add(op.results[0].uid)
            elif nm == "neptune.yield":
                pass
            else:
                _err(
                    f"@{fn.name}: scalar op {nm} not allowed in a "
                    "linear_opdef apply body"
                )


# --------------------------------------------------------------------------
# 3. structure keys
# --------------------------------------------------------------------------


def _structure_key(fn: Function) -> str:
    """Canonical structure string (reference `VerifyAndAnnotate.cpp:228-294`):
    kind, signature, and per-apply bounds + per-input sorted access offsets;
    for nonlinear opdefs additionally the sorted scalar-op multiset.

    Deviation from the reference: the in-order constant values are included
    too. The reference's key is purely structural because it only routes
    dlsym lookups; here the hash keys *callable sharing* between
    structurally-identical opdefs, so operators differing only in baked-in
    coefficients must not collide."""
    parts = [fn.kind, str(fn.ftype)]
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            body = op.region(0)
            rank = op.results[0].type.bounds.rank
            per_input: dict[int, list] = {}
            scalar_ops: list[str] = []
            consts: list[str] = []
            for inner in body.ops:
                if inner.name == "neptune.access":
                    src = inner.operands[0]
                    if src.block_arg_of is body:
                        per_input.setdefault(src.index - rank, []).append(
                            tuple(inner.attrs["offset"])
                        )
                elif inner.name == "arith.constant":
                    consts.append(repr(inner.attrs["value"]))
                    scalar_ops.append(inner.name)
                elif inner.name in SCALAR_OPS:
                    scalar_ops.append(inner.name)
            acc = ";".join(
                f"in{k}:" + ",".join(str(list(o)) for o in sorted(offs))
                for k, offs in sorted(per_input.items())
            )
            parts.append(f"apply[{op.attrs['bounds']}]({acc})")
            if op.attrs.get("periodic"):
                # torus wrap changes lowering semantics (roll vs zero-fill
                # edges); omitting it collided a periodic operator with
                # its bounded twin in the shared callable cache
                parts.append("periodic")
            parts.append("consts(" + ",".join(consts) + ")")
            # full dataflow serialization: op sequence with SSA wiring, so the
            # hash is a sound semantic fingerprint (not just a structural one)
            numbering: dict[int, str] = {
                a.uid: f"a{i}" for i, a in enumerate(body.args)
            }
            ser = []
            for idx, inner in enumerate(body.ops):
                for r in inner.results:
                    numbering[r.uid] = f"t{idx}.{r.index}"
                operands = ",".join(
                    numbering.get(o.uid, "?") for o in inner.operands
                )
                extra = ""
                if inner.name == "neptune.access":
                    extra = str(list(inner.attrs["offset"]))
                elif inner.name == "arith.constant":
                    extra = repr(inner.attrs["value"])
                elif inner.name == "arith.cmp":
                    extra = inner.attrs["pred"]
                elif inner.name == "arith.cast":
                    extra = inner.attrs["to"]
                ser.append(f"{inner.name}{extra}({operands})")
            parts.append("body[" + ";".join(ser) + "]")
            if fn.kind == "nonlinear_opdef":
                parts.append("ops(" + ",".join(sorted(scalar_ops)) + ")")
        elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            parts.append(f"call@{op.attrs['symbol']}")
        elif op.name != "neptune.return":
            # any other field-level op (reduce, solver ops in nonlinear
            # opdef bodies, ...): serialize name + sorted attrs so bodies
            # differing only here don't collide in the callable cache
            attrs = ",".join(
                f"{k}={v!r}" for k, v in sorted(op.attrs.items())
            )
            parts.append(f"op:{op.name}[{attrs}]")
    return "|".join(parts)


def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")


# --------------------------------------------------------------------------
# 5. reach analysis (effective stencil shape -> halo widths)
# --------------------------------------------------------------------------

_ZERO_REACH_OPS = ("neptune.load", "neptune.from_tensor")


def _opdef_total_shape(fn: Function, module: Module) -> StencilShape:
    """Effective offset set relating each output point to input points,
    composed through the opdef's dataflow (Minkowski composition)."""
    rank = fn.ftype.inputs[0].bounds.rank if fn.ftype.inputs else 0
    zero = StencilShape(((0,) * rank,)) if rank else StencilShape(())
    reach: dict[int, StencilShape] = {a.uid: zero for a in fn.body.args}

    def get(v: Value) -> StencilShape:
        return reach.get(v.uid, StencilShape(()))

    for op in fn.body.ops:
        if op.name == "neptune.apply":
            shape: StencilShape = op.attrs.get("shape") or StencilShape(())
            body = op.region(0)
            r = op.results[0].type.bounds.rank
            total = StencilShape(())
            # per-input offsets compose with that input's own reach
            per_input: dict[int, set] = {}
            for inner in body.ops:
                if inner.name == "neptune.access":
                    src = inner.operands[0]
                    if src.block_arg_of is body:
                        per_input.setdefault(src.index - r, set()).add(
                            tuple(inner.attrs["offset"])
                        )
            for k, offs in per_input.items():
                s = StencilShape(tuple(sorted(offs))).compose(get(op.operands[k]))
                total = total.union(s)
            n_in = op.attrs.get("num_inputs", len(op.operands))
            if not per_input and n_in > 0:
                # copy-through-only apply still propagates input0 at offset 0
                total = get(op.operands[0])
            out_bounds = op.results[0].type.bounds
            if op.attrs.get("bounds") != out_bounds:
                # sub-domain apply: points outside `bounds` are copy-through
                # seeds from input j (executor semantics) — union their
                # identity reach so downstream halos stay conservative
                for j in range(min(len(op.results), n_in)):
                    total = total.union(get(op.operands[j]))
            # ALL results of a multi-result apply carry the body's reach
            # (assigning results[0] only would give dataflow through
            # results[1:] an empty reach -> zero-width halo exchange)
            for res in op.results:
                reach[res.uid] = total
        elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            callee = module.lookup(op.attrs["symbol"])
            callee_shape: StencilShape = callee.attrs.get(
                "total_shape", StencilShape(())
            )
            arg_reach = StencilShape(())
            for a in op.operands:
                arg_reach = arg_reach.union(get(a))
            s = callee_shape.compose(arg_reach)
            for res in op.results:
                reach[res.uid] = s
        elif op.results:
            # elementwise/bridging ops propagate union of operand reaches
            s = StencilShape(())
            for a in op.operands:
                s = s.union(get(a))
            for res in op.results:
                reach[res.uid] = s

    term = fn.body.terminator
    total = StencilShape(())
    if term is not None:
        for v in term.operands:
            total = total.union(get(v))
    return total


# --------------------------------------------------------------------------
# pass driver
# --------------------------------------------------------------------------


def verify_and_annotate(module: Module) -> Module:
    """Run all checks and attach `structure_key`, `structure_key_hash`,
    `total_shape`, and `halo` to every opdef. Mutates and returns `module`."""
    # symbol resolution for every symbol-bearing op (VerifyAndAnnotate.cpp:375-384)
    for op in module.walk():
        for key in ("symbol", "system", "rhs", "residual", "jacobian"):
            sym = op.attrs.get(key)
            if sym is not None and sym not in module.functions:
                _err(f"op {op.name}: unresolved symbol @{sym} (attr {key})")

    for fn in module.functions.values():
        if fn.is_opdef:
            _verify_opdef_common(fn)
            if fn.kind == "linear_opdef":
                _verify_linear_body(fn)
        for op in fn.walk():
            if op.name == "neptune.apply":
                _verify_apply_region(op)

    # annotate opdefs in dependency order (callees before callers)
    done: set[str] = set()

    def annotate(fn: Function, stack: tuple[str, ...] = ()):
        if fn.name in done:
            return
        if fn.name in stack:
            _err(f"recursive opdef cycle involving @{fn.name}")
        for op in fn.body.ops:
            if op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
                annotate(module.lookup(op.attrs["symbol"]), stack + (fn.name,))
        key = _structure_key(fn)
        fn.attrs["structure_key"] = key
        fn.attrs["structure_key_hash"] = _hash64(key)
        shape = _opdef_total_shape(fn, module)
        fn.attrs["total_shape"] = shape
        fn.attrs["halo"] = shape.halo()
        done.add(fn.name)

    for fn in module.opdefs():
        annotate(fn)
    return module
