"""Typed op builders + build-time verification for the Neptune-TPU stencil IR.

One builder method per reference NeptuneIR op (op list:
`include/Dialect/NeptuneIR/NeptuneIROps.td`, per-op verifiers:
`lib/Dialect/NeptuneIR/NeptuneIRVerifier.cpp`). Scalar arithmetic inside apply
bodies maps to `arith.*` / `math.*` ops, as in the reference's kernel regions.

Conventions:
  * Apply regions have block args ``rank × index`` then one arg per input temp
    (reference ApplyOp contract, `NeptuneIROps.td:164-197`,
    `VerifyAndAnnotate.cpp:96-135`).
  * `store` has buffer-write semantics on its field operand and no results
    (reference memory-effect annotation, `NeptuneIRVerifier.cpp:385-390`).
  * Conditionals inside kernels use functional `arith.select` (the reference's
    `scf.if` usage in residual kernels, e.g.
    `test/smoke_tests/smoke_time_advance_nonlinear.mlir:37-80`, is expressible
    as select because both branches are pure).
"""

from __future__ import annotations

from typing import Optional, Sequence

from .core import Block, Builder, Function, Operation, Value
from .types import (
    BOOL,
    INDEX,
    Bounds,
    FieldType,
    FunctionType,
    Location,
    MatrixType,
    ScalarType,
    StencilShape,
    TempType,
    TensorType,
)

LINEAR_SOLVERS = ("cg", "gmres", "bicgstab", "chebyshev", "direct")
NONLINEAR_METHODS = ("newton", "newton-krylov", "picard")
REDUCE_KINDS = ("sum", "max", "min", "l1", "l2")

_FLOAT_SCALARS = {"float64", "float32", "bfloat16"}


def _is_float(t) -> bool:
    return isinstance(t, ScalarType) and t.name in _FLOAT_SCALARS


class IRError(ValueError):
    """Raised on op-contract violations (the analog of MLIR verifier errors)."""


def _check(cond: bool, msg: str):
    if not cond:
        raise IRError(msg)


class NeptuneBuilder(Builder):
    """Builder with one method per Neptune-TPU op."""

    # ------------------------------------------------------------------
    # buffer <-> field <-> temp bridges
    # ------------------------------------------------------------------

    def wrap(self, buf: Value, ftype: FieldType) -> Value:
        """tensor -> field (reference `neptune_ir.wrap`, NeptuneIROps.td:20-36)."""
        _check(isinstance(buf.type, TensorType), f"wrap expects tensor, got {buf.type}")
        _check(
            buf.type.shape == ftype.bounds.shape,
            f"wrap: buffer shape {buf.type.shape} != field physical shape "
            f"{ftype.bounds.shape}",
        )
        return self.create("neptune.wrap", [buf], result_types=[ftype]).result

    def unwrap(self, field: Value) -> Value:
        """field -> tensor (reference `neptune_ir.unwrap`, NeptuneIROps.td:44-60)."""
        ft = field.type
        _check(isinstance(ft, FieldType), f"unwrap expects field, got {ft}")
        return self.create(
            "neptune.unwrap", [field], result_types=[TensorType(ft.element, ft.shape)]
        ).result

    def load(self, field: Value) -> Value:
        """field -> temp (reference `neptune_ir.load`, NeptuneIROps.td:68-84)."""
        ft = field.type
        _check(isinstance(ft, FieldType), f"load expects field, got {ft}")
        return self.create("neptune.load", [field], result_types=[ft.temp()]).result

    def store(self, temp: Value, field: Value, bounds: Optional[Bounds] = None):
        """temp -> field write, optional sub-domain `bounds`
        (reference `neptune_ir.store`, NeptuneIROps.td:238-259)."""
        tt, ft = temp.type, field.type
        _check(isinstance(tt, TempType), f"store expects temp, got {tt}")
        _check(isinstance(ft, FieldType), f"store target must be field, got {ft}")
        _check(tt.element == ft.element, "store element type mismatch")
        if bounds is not None:
            _check(
                ft.bounds.contains(bounds) and tt.bounds.contains(bounds),
                f"store bounds {bounds} not within field {ft.bounds} / temp {tt.bounds}",
            )
        else:
            _check(tt.bounds == ft.bounds, "full store requires matching bounds")
        attrs = {"bounds": bounds} if bounds is not None else {}
        self.create("neptune.store", [temp, field], attrs=attrs)

    def as_tensor(self, temp: Value) -> Value:
        """temp -> tensor (reference NeptuneIROps.td:539-562)."""
        tt = temp.type
        _check(isinstance(tt, TempType), f"as_tensor expects temp, got {tt}")
        return self.create(
            "neptune.as_tensor", [temp], result_types=[TensorType(tt.element, tt.shape)]
        ).result

    def from_tensor(self, tensor: Value, ttype: TempType) -> Value:
        """tensor -> temp (reference NeptuneIROps.td:574-596)."""
        _check(isinstance(tensor.type, TensorType), "from_tensor expects tensor")
        _check(
            tensor.type.shape == ttype.bounds.shape,
            f"from_tensor shape {tensor.type.shape} != temp shape {ttype.bounds.shape}",
        )
        return self.create(
            "neptune.from_tensor", [tensor], result_types=[ttype]
        ).result

    # ------------------------------------------------------------------
    # apply / access / yield
    # ------------------------------------------------------------------

    def start_apply(
        self,
        inputs: Sequence[Value],
        bounds: Bounds,
        result_type: Optional[TempType] = None,
        scalar_params: Sequence[Value] = (),
        result_types: Optional[Sequence[TempType]] = None,
        periodic: bool = False,
    ) -> tuple[Operation, Block]:
        """Create an apply op with an empty region; caller fills the body and
        then calls `finish_apply`.

        Reference ApplyOp (`NeptuneIROps.td:164-197`): region args are
        rank × index IVs followed by one arg per input temp; result is a temp
        spanning the full type bounds with values computed on `bounds` and
        copy-through of input0 elsewhere (`DataflowLowering.cpp:281-287`).

        Extension over the reference: trailing `scalar_params` operands (e.g.
        a runtime `dt`) become extra scalar block args after the temp inputs —
        the reference can only bake such values in as constants
        (`HighLevelConvertion.cpp:77-120` hard-codes the dt combination body).
        """
        for v in inputs:
            _check(isinstance(v.type, TempType), f"apply input must be temp: {v.type}")
        for v in scalar_params:
            _check(
                isinstance(v.type, ScalarType),
                f"apply scalar param must be scalar: {v.type}",
            )
        if result_types is not None:
            rtypes = list(result_types)
            _check(len(rtypes) >= 1, "apply needs at least one result")
        else:
            if result_type is None:
                _check(
                    len(inputs) > 0, "apply without inputs needs explicit result_type"
                )
                result_type = inputs[0].type
            rtypes = [result_type]
        rank = rtypes[0].bounds.rank
        for rt in rtypes:
            _check(
                rt.bounds == rtypes[0].bounds,
                "multi-result apply requires identical result domains",
            )
        _check(bounds.rank == rank, "apply bounds rank != result rank")
        _check(
            rtypes[0].bounds.contains(bounds),
            f"apply bounds {bounds} outside result domain {rtypes[0].bounds}",
        )
        for v in inputs:
            _check(v.type.rank == rank, "apply input rank mismatch")
        body = Block(
            [INDEX] * rank + [v.type for v in inputs] + [v.type for v in scalar_params],
            [f"i{d}" for d in range(rank)]
            + [f"in{k}" for k in range(len(inputs))]
            + [f"s{k}" for k in range(len(scalar_params))],
        )
        attrs = {"bounds": bounds, "num_inputs": len(inputs)}
        if periodic:
            # out-of-domain accesses are *specified* to wrap (torus domain);
            # every backend must honor it (the jnp lowering rolls; the
            # native runtime uses modular indexing)
            attrs["periodic"] = True
        op = self.create(
            "neptune.apply",
            list(inputs) + list(scalar_params),
            attrs=attrs,
            result_types=rtypes,
            regions=[body],
        )
        return op, body

    def finish_apply(self, op: Operation) -> Value:
        body = op.region(0)
        term = body.terminator
        _check(
            term is not None and term.name == "neptune.yield",
            "apply body must end with neptune.yield",
        )
        _check(
            len(term.operands) == len(op.results),
            f"apply yields {len(term.operands)} values for {len(op.results)} results",
        )
        for yielded, res in zip(term.operands, op.results):
            _check(
                isinstance(yielded.type, ScalarType)
                and yielded.type.name == res.type.element,
                f"yield type {yielded.type} != apply element {res.type.element}",
            )
        # Annotate the access-offset union (feeds structure keys, halo widths
        # and kernel selection; reference collects the same in
        # VerifyAndAnnotate.cpp:252-266).
        offsets = []
        for inner in op.walk():
            if inner.name == "neptune.access":
                offsets.append(tuple(inner.attrs["offset"]))
        op.attrs["shape"] = StencilShape.of(offsets) if offsets else StencilShape(())
        return op.results[0] if len(op.results) == 1 else tuple(op.results)

    def access(self, temp_arg: Value, offset: Sequence[int]) -> Value:
        """Read neighbor at constant offset (reference `neptune_ir.access`,
        NeptuneIROps.td:205-228)."""
        tt = temp_arg.type
        _check(isinstance(tt, TempType), f"access expects temp, got {tt}")
        off = tuple(int(o) for o in offset)
        _check(
            len(off) == tt.rank,
            f"access offset rank {len(off)} != temp rank {tt.rank}",
        )
        return self.create(
            "neptune.access",
            [temp_arg],
            attrs={"offset": off},
            result_types=[tt.element_scalar],
        ).result

    def yield_(self, value):
        """Apply-region terminator (reference NeptuneIROps.td:94-114). The
        reference MVP enforces a single scalar (`VerifyAndAnnotate.cpp:
        137-138`); this build allows multiple yields for multi-result applies
        (multi-field residual kernels, the test_swe_implicit.py API)."""
        values = list(value) if isinstance(value, (list, tuple)) else [value]
        for v in values:
            _check(isinstance(v.type, ScalarType), "yield expects scalar(s)")
        self.create("neptune.yield", values)

    def return_(self, values: Sequence[Value]):
        """Opdef/func terminator (reference NeptuneIROps.td:124-145)."""
        self.create("neptune.return", list(values))

    # ------------------------------------------------------------------
    # reductions
    # ------------------------------------------------------------------

    def reduce(self, temp: Value, kind: str, bounds: Optional[Bounds] = None) -> Value:
        """field/temp -> scalar reduction (reference NeptuneIROps.td:272-299;
        the reference implements only "sum", `DataflowLowering.cpp:652-654` —
        here all of sum/max/min/l1/l2 are supported). A field operand gets an
        implicit load, matching the reference op's field signature."""
        _check(kind in REDUCE_KINDS, f"unknown reduce kind {kind!r}")
        if isinstance(temp.type, FieldType):
            temp = self.load(temp)
        tt = temp.type
        _check(isinstance(tt, TempType), f"reduce expects temp, got {tt}")
        if bounds is not None:
            _check(tt.bounds.contains(bounds), "reduce bounds outside temp domain")
        attrs = {"kind": kind}
        if bounds is not None:
            attrs["bounds"] = bounds
        return self.create(
            "neptune.reduce", [temp], attrs=attrs, result_types=[tt.element_scalar]
        ).result

    # ------------------------------------------------------------------
    # operator definitions and applications
    # ------------------------------------------------------------------

    def make_opdef(
        self,
        name: str,
        kind: str,
        input_types: Sequence[TempType],
        result_types: Sequence[TempType],
    ) -> Function:
        """Create a linear/nonlinear opdef symbol (reference
        NeptuneIROps.td:318-449). Signature contract `(Temp...) -> (Temp...)`
        per `VerifyAndAnnotate.cpp:62-90`, extended here to allow *trailing*
        scalar inputs (lifted scalar captures such as a traced dt)."""
        seen_scalar = False
        for t in input_types:
            if isinstance(t, ScalarType):
                seen_scalar = True
            else:
                _check(
                    isinstance(t, TempType) and not seen_scalar,
                    f"opdef inputs must be temps then trailing scalars, got {t}",
                )
        for t in result_types:
            _check(isinstance(t, TempType), f"opdef results must be temps, got {t}")
        return self.make_function(
            name,
            kind,
            list(input_types),
            list(result_types),
            arg_names=[f"arg{i}" for i in range(len(input_types))],
        )

    def apply_linear(self, symbol: str, args: Sequence[Value]) -> Value:
        """Matrix-free y = A(x) of a linear_opdef (reference
        NeptuneIROps.td:461-488)."""
        return self._apply_opdef("neptune.apply_linear", "linear_opdef", symbol, args)

    def apply_nonlinear(self, symbol: str, args: Sequence[Value]) -> Value:
        """Apply a nonlinear_opdef (reference NeptuneIROps.td:500-527)."""
        return self._apply_opdef(
            "neptune.apply_nonlinear", "nonlinear_opdef", symbol, args
        )

    def _apply_opdef(self, opname, expected_kind, symbol, args):
        fn = self.module.lookup(symbol)
        _check(
            fn.kind == expected_kind,
            f"{opname} target @{symbol} is a {fn.kind}, expected {expected_kind}",
        )
        _check(
            len(args) == len(fn.ftype.inputs),
            f"{opname} @{symbol}: got {len(args)} args, expects "
            f"{len(fn.ftype.inputs)}",
        )
        for a, t in zip(args, fn.ftype.inputs):
            _check(a.type == t, f"{opname} @{symbol}: arg type {a.type} != {t}")
        op = self.create(
            opname,
            list(args),
            attrs={"symbol": symbol},
            result_types=list(fn.ftype.results),
        )
        return op.result if len(op.results) == 1 else tuple(op.results)

    # ------------------------------------------------------------------
    # solver ops
    # ------------------------------------------------------------------

    def assemble_matrix(self, symbol: str) -> Value:
        """Materialize an operator handle from a linear_opdef (reference
        NeptuneIROps.td:607-632; the reference returns a lazy handle disguised
        as memref<?x?xf64>, `NeptunePETScRuntime.cpp:614-631` — here the type
        is an honest MatrixType and assembly-to-dense is an explicit request
        at solve/lowering time)."""
        fn = self.module.lookup(symbol)
        _check(fn.kind == "linear_opdef", f"assemble_matrix target @{symbol} not linear")
        _check(
            len(fn.ftype.inputs) == 1 and len(fn.ftype.results) == 1,
            "assemble_matrix requires a unary operator (MVP parity with "
            "reference verifier NeptuneIRVerifier.cpp:211-279)",
        )
        tt: TempType = fn.ftype.inputs[0]
        return self.create(
            "neptune.assemble_matrix",
            [],
            attrs={"symbol": symbol},
            result_types=[MatrixType(tt.element, tt.bounds.size)],
        ).result

    def solve_linear(
        self,
        matrix: Value,
        rhs: Value,
        solver: str = "cg",
        tol: float = 1e-6,
        max_iters: int = 1000,
        precond: str = "none",
        verbose: bool = False,
        precision: str = "full",
        options=None,
    ) -> Value:
        """Solve A x = b (reference NeptuneIROps.td:646-684; solver attrs
        "cg"/"gmres"/"bicgstab" + tol + max_iters; preconditioner is new here —
        the reference defaults to PCNONE, `NeptunePETScRuntime.cpp:146-149`).

        options: extra per-solve runtime options (dict or PETSc-style string,
        e.g. {"restart": 50, "atol": 1e-12, "divtol": 1e5}) — the analog of
        the reference's per-object PETSc options string
        (`NeptunePETScRuntime.cpp:139-150, 284-298`)."""
        _check(isinstance(matrix.type, MatrixType), "solve_linear expects matrix")
        _check(isinstance(rhs.type, TempType), "solve_linear rhs must be temp")
        _check(solver in LINEAR_SOLVERS, f"unknown solver {solver!r}")
        _check(
            matrix.type.n == rhs.type.bounds.size,
            f"solve_linear: matrix dim {matrix.type.n} != rhs size "
            f"{rhs.type.bounds.size}",
        )
        _check(
            matrix.type.element == rhs.type.element,
            "solve_linear element type mismatch (reference rejects f32 system "
            "vs f64 rhs, test/mlir_tests/solve-linear-invalid-system.mlir)",
        )
        from ..utils.options import LINEAR_OPTION_KEYS, parse_options

        opts = parse_options(options, LINEAR_OPTION_KEYS, where="solve_linear")
        attrs = {
            "solver": solver,
            "tol": float(tol),
            "max_iters": int(max_iters),
            "precond": precond,
            "verbose": bool(verbose),
            "precision": precision,
        }
        if opts:
            attrs["options"] = opts
        return self.create(
            "neptune.solve_linear",
            [matrix, rhs],
            attrs=attrs,
            result_types=[rhs.type],
        ).result

    def solve_nonlinear(
        self,
        residual: str,
        initial_guess: Sequence[Value],
        captures: Sequence[Value] = (),
        jacobian: Optional[str] = None,
        method: str = "newton",
        tol: float = 1e-8,
        max_iters: int = 50,
        krylov_tol: float = 1e-6,
        krylov_iters: int = 200,
        verbose: bool = False,
        options=None,
    ) -> Value | tuple[Value, ...]:
        """Solve F(u; captures) = 0 (reference NeptuneIROps.td:697-736).

        The residual opdef signature is (state..., captures...) -> (state...),
        generalizing the reference's single-state + 0..2-capture ABI
        (`RuntimeLowering.cpp:217-378`) to arbitrary multi-field states — the
        target API of `test/python_tests/test_swe_implicit.py:83-89`.
        """
        fn = self.module.lookup(residual)
        _check(fn.kind == "nonlinear_opdef", f"@{residual} is not a nonlinear_opdef")
        _check(method in NONLINEAR_METHODS, f"unknown method {method!r}")
        n_state = len(initial_guess)
        _check(n_state >= 1, "solve_nonlinear needs at least one state")
        _check(
            len(fn.ftype.inputs) == n_state + len(captures),
            f"residual @{residual} arity {len(fn.ftype.inputs)} != "
            f"{n_state} states + {len(captures)} captures",
        )
        _check(
            len(fn.ftype.results) == n_state,
            f"residual @{residual} must return one temp per state",
        )
        operands = list(initial_guess) + list(captures)
        for a, t in zip(operands, fn.ftype.inputs):
            _check(a.type == t, f"solve_nonlinear arg {a.type} != residual input {t}")
        if jacobian is not None:
            # use-or-reject: the reference accepts `jacobian` but never
            # consumes it (NeptuneIROps.td:705 "supply a linearization";
            # no consumer in HighLevelConvertion.cpp / RuntimeLowering.cpp).
            # Here it is USED — the opdef computes J·v for the inner Krylov
            # solve — so malformed signatures are hard errors, not silently
            # swallowed user input. Two accepted shapes:
            #   (v_states...) -> states                  constant Jacobian
            #   (v..., u..., captures...) -> states      J(u; captures)·v
            _check(
                jacobian in self.module.functions,
                f"unresolved jacobian symbol @{jacobian}",
            )
            jfn = self.module.lookup(jacobian)
            _check(jfn.is_opdef, f"jacobian @{jacobian} is not an opdef")
            state_tys = [v.type for v in initial_guess]
            const_form = state_tys
            full_form = state_tys + state_tys + [c.type for c in captures]
            _check(
                list(jfn.ftype.inputs) in (const_form, full_form),
                f"jacobian @{jacobian} signature {list(jfn.ftype.inputs)} "
                f"matches neither (v_states...) nor (v..., u..., captures...); "
                f"expected {const_form} or {full_form}",
            )
            _check(
                list(jfn.ftype.results) == state_tys,
                f"jacobian @{jacobian} must return one temp per state",
            )
        from ..utils.options import NONLINEAR_OPTION_KEYS, parse_options

        opts = parse_options(options, NONLINEAR_OPTION_KEYS, where="solve_nonlinear")
        attrs = {
            "residual": residual,
            "jacobian": jacobian,
            "method": method,
            "tol": float(tol),
            "max_iters": int(max_iters),
            "krylov_tol": float(krylov_tol),
            "krylov_iters": int(krylov_iters),
            "num_states": n_state,
            "verbose": bool(verbose),
        }
        if opts:
            attrs["options"] = opts
        op = self.create(
            "neptune.solve_nonlinear",
            operands,
            attrs=attrs,
            result_types=[v.type for v in initial_guess],
        )
        return op.result if n_state == 1 else tuple(op.results)

    def time_advance(
        self,
        state: Value,
        dt: Value | float,
        method: int,
        system: Optional[str] = None,
        rhs: Optional[str] = None,
        residual: Optional[str] = None,
        jacobian: Optional[str] = None,
        solver: str = "gmres",
        tol: float = 1e-8,
        max_iters: int = 200,
        precond: str = "none",
        scheme: str = "euler",
        options=None,
    ) -> Value:
        """One time step (reference NeptuneIROps.td:746-774; verifier
        `NeptuneIRVerifier.cpp:307-340`). `scheme` selects the explicit
        integrator (euler | rk2 | rk4) — an extension over the reference's
        hard-coded forward Euler (`HighLevelConvertion.cpp:77-120`).
        `options` carries per-solve runtime options forwarded to the implicit
        solver (see solve_linear/solve_nonlinear)."""
        _check(isinstance(state.type, TempType), "time_advance state must be temp")
        from .types import TimeMethod

        method = int(method)
        TimeMethod(method)  # validates
        if not isinstance(dt, Value):
            dt = self.constant(float(dt), state.type.element_scalar)
        _check(_is_float(dt.type), "time_advance dt must be a float scalar")
        if method == TimeMethod.EXPLICIT:
            _check(rhs is not None, "explicit time_advance requires rhs symbol")
        elif method == TimeMethod.IMPLICIT_LINEAR:
            _check(system is not None, "implicit_linear requires system symbol")
        elif method == TimeMethod.IMPLICIT_NONLINEAR:
            _check(residual is not None, "implicit_nonlinear requires residual symbol")
        from ..utils.options import (
            LINEAR_OPTION_KEYS,
            NONLINEAR_OPTION_KEYS,
            parse_options,
        )

        okeys = (
            NONLINEAR_OPTION_KEYS
            if method == TimeMethod.IMPLICIT_NONLINEAR
            else LINEAR_OPTION_KEYS
        )
        opts = parse_options(options, okeys, where="time_advance")
        attrs = {
            "method": method,
            "system": system,
            "rhs": rhs,
            "residual": residual,
            "jacobian": jacobian,
            "solver": solver,
            "tol": float(tol),
            "max_iters": int(max_iters),
            "precond": precond,
            "scheme": scheme,
        }
        if opts:
            attrs["options"] = opts
        return self.create(
            "neptune.time_advance",
            [state, dt],
            attrs=attrs,
            result_types=[state.type],
        ).result

    def time_advance_runtime(
        self, state: Value, dt: Value, method: Value, rhs: Optional[str]
    ) -> Value:
        """Runtime-dispatched time step (reference NeptuneIROps.td:783-811;
        produced from method=runtime by HighLevelConvertion.cpp:162-168).
        Lowered to `lax.switch` over the method scalar."""
        _check(isinstance(state.type, TempType), "state must be temp")
        return self.create(
            "neptune.time_advance_runtime",
            [state, dt, method],
            attrs={"rhs": rhs},
            result_types=[state.type],
        ).result

    # ------------------------------------------------------------------
    # scalar arithmetic (apply-body ops)
    # ------------------------------------------------------------------

    def constant(self, value, type: ScalarType) -> Value:
        if type.name == "index":
            value = int(value)
        elif type.name == "bool":
            value = bool(value)
        elif type.name == "int32":
            value = int(value)
        else:
            value = float(value)
        return self.create(
            "arith.constant", [], attrs={"value": value}, result_types=[type]
        ).result

    def _binary(self, name: str, a: Value, b: Value) -> Value:
        _check(
            a.type == b.type,
            f"{name}: operand type mismatch {a.type} vs {b.type}",
        )
        return self.create(name, [a, b], result_types=[a.type]).result

    def add(self, a, b):
        return self._binary("arith.add", a, b)

    def sub(self, a, b):
        return self._binary("arith.sub", a, b)

    def mul(self, a, b):
        return self._binary("arith.mul", a, b)

    def div(self, a, b):
        return self._binary("arith.div", a, b)

    def pow(self, a, b):
        return self._binary("arith.pow", a, b)

    def minimum(self, a, b):
        return self._binary("arith.min", a, b)

    def maximum(self, a, b):
        return self._binary("arith.max", a, b)

    def neg(self, a):
        return self.create("arith.neg", [a], result_types=[a.type]).result

    def cmp(self, pred: str, a: Value, b: Value) -> Value:
        _check(pred in ("eq", "ne", "lt", "le", "gt", "ge"), f"bad predicate {pred}")
        _check(a.type == b.type, f"cmp operand mismatch {a.type} vs {b.type}")
        return self.create(
            "arith.cmp", [a, b], attrs={"pred": pred}, result_types=[BOOL]
        ).result

    def select(self, cond: Value, a: Value, b: Value) -> Value:
        _check(cond.type == BOOL, "select condition must be bool")
        _check(a.type == b.type, f"select branch mismatch {a.type} vs {b.type}")
        return self.create("arith.select", [cond, a, b], result_types=[a.type]).result

    def logical_and(self, a, b):
        _check(a.type == BOOL and b.type == BOOL, "and expects bools")
        return self.create("arith.and", [a, b], result_types=[BOOL]).result

    def logical_or(self, a, b):
        _check(a.type == BOOL and b.type == BOOL, "or expects bools")
        return self.create("arith.or", [a, b], result_types=[BOOL]).result

    def logical_not(self, a):
        _check(a.type == BOOL, "not expects bool")
        return self.create("arith.not", [a], result_types=[BOOL]).result

    def cast(self, a: Value, to: ScalarType) -> Value:
        if a.type == to:
            return a
        return self.create(
            "arith.cast", [a], attrs={"to": to.name}, result_types=[to]
        ).result

    def unary_math(self, fname: str, a: Value) -> Value:
        _check(
            fname in ("exp", "log", "sqrt", "sin", "cos", "tan", "tanh", "abs", "erf"),
            f"unknown math fn {fname}",
        )
        _check(_is_float(a.type), f"math.{fname} expects float scalar, got {a.type}")
        return self.create(f"math.{fname}", [a], result_types=[a.type]).result


SCALAR_OPS = (
    "arith.constant",
    "arith.add",
    "arith.sub",
    "arith.mul",
    "arith.div",
    "arith.pow",
    "arith.min",
    "arith.max",
    "arith.neg",
    "arith.cmp",
    "arith.select",
    "arith.and",
    "arith.or",
    "arith.not",
    "arith.cast",
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
