"""Module executor: lowers Neptune-TPU IR functions to jittable JAX callables.

This layer plays the combined role of the reference's StructureLowering +
RuntimeLowering + compiled-code loading:

  * opdefs become cached traced callables (reference lowers them to
    `func.func` + `func.call`, `lib/Passes/StructureLowering.cpp:30-141`;
    solver callbacks then reach them via dlsym at runtime,
    `NeptunePETScRuntime.cpp:182-230` — in JAX the callable is closed over at
    trace time, SURVEY.md §7 hard part (d));
  * solver ops dispatch into `neptune_tpu.solvers` (reference emits
    `_neptune_rt_<runtime>_…` shim calls, `lib/Passes/RuntimeLowering.cpp`);
  * field buffer semantics (wrap/load/store/unwrap) run against a per-call
    storage-cell environment, reproducing the reference's memref mutation
    semantics inside a functional trace.

The returned callables are pure jnp-in/jnp-out functions: wrap them in
`jax.jit` (or let `frontend.jit_compile` do it) and the whole program —
stencil sweeps, Krylov loops, Newton iterations — compiles to one XLA
executable per entry point.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..config import config
from ..ir.core import Function, Module, Operation
from ..ir.types import (
    Bounds,
    FieldType,
    MatrixType,
    ScalarType,
    TempType,
    TensorType,
    TimeMethod,
)
from ..solvers import krylov
from ..solvers.assemble import MatrixHandle
from ..solvers.newton import newton_krylov, picard
from ..solvers.precond import make_preconditioner
from ..utils import profiling
from . import jnp_backend


# "auto" is the same lowering as "jnp": XLA compiles it for every platform.
BACKENDS = ("auto", "jnp")


class CompiledModule:
    """Executable view of a verified module."""

    def __init__(self, module: Module, backend: Optional[str] = None):
        self.module = module
        self.backend = backend or config.backend
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}: the JAX lowering is "
                "'jnp' ('auto' is the same); the native C++ oracle is "
                "neptune_tpu.runtime.compile_native"
            )
        self._opdef_cache: dict[str, Callable] = {}
        self._structure_cache: dict[int, Callable] = {}
        self._fn_cache: dict[str, Callable] = {}
        self._lo_cm: Optional["CompiledModule"] = None

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    def opdef(self, name: str) -> Callable:
        """Traced callable for a linear/nonlinear opdef: (*arrays) -> array(s).

        Callables are shared between structurally identical opdefs via the
        verifier's structure-key hash — the reference's kernel-cache key
        (`VerifyAndAnnotate.cpp:279-293` MD5 keyHash) applied to avoid
        re-tracing/re-jitting duplicate operators. `jax.jvp`/`jax.grad`
        (the JFNK residual in `solvers/newton.py`) differentiate through
        them.
        """
        if name not in self._opdef_cache:
            fn = self.module.lookup(name)
            assert fn.is_opdef, f"@{name} is not an opdef"
            skey = fn.attrs.get("structure_key_hash")
            if skey is not None and skey in self._structure_cache:
                self._opdef_cache[name] = self._structure_cache[skey]
            else:
                cb = self._make_callable(fn)
                self._opdef_cache[name] = cb
                if skey is not None:
                    self._structure_cache[skey] = cb
        return self._opdef_cache[name]

    def function(self, name: str) -> Callable:
        """Traced callable for a plain function."""
        if name not in self._fn_cache:
            fn = self.module.lookup(name)
            self._fn_cache[name] = self._make_callable(fn)
        return self._fn_cache[name]

    def jit_function(self, name: str, **jit_kwargs) -> Callable:
        return jax.jit(self.function(name), **jit_kwargs)

    def sweeps(self, name: str, k: int) -> Callable:
        """x -> opdef @name applied k times (fixed-point / smoother sweeps),
        as a `lax.fori_loop` of single applies — the reference runtime's
        KSP Richardson replay of the operator kernel."""
        fn = self.module.lookup(name)
        assert fn.is_opdef, f"@{name} is not an opdef"
        n_temps = sum(1 for t in fn.ftype.inputs if isinstance(t, TempType))
        if n_temps != 1 or len(fn.ftype.results) != 1:
            raise ValueError(
                f"sweeps(@{name}): repeated application needs a unary "
                f"operator (one temp in, one temp out); got {n_temps} "
                f"inputs, {len(fn.ftype.results)} results"
            )
        one = self.opdef(name)

        def run_loop(x, *scalars):
            return jax.lax.fori_loop(
                0, k, lambda _, u: one(u, *scalars), jnp.asarray(x)
            )

        return run_loop

    def low_precision_opdef(self, name: str) -> Callable:
        """float32 twin of an opdef (for mixed-precision refinement)."""
        if self._lo_cm is None:
            from ..passes.retype import retype_module

            self._lo_cm = CompiledModule(
                retype_module(self.module, "float32"), self.backend
            )
        return self._lo_cm.opdef(name)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _make_callable(self, fn: Function) -> Callable:
        def run(*args):
            if len(args) != len(fn.body.args):
                raise TypeError(
                    f"@{fn.name} expects {len(fn.body.args)} args, got {len(args)}"
                )
            env: dict[int, object] = {}
            cells: dict[int, jnp.ndarray] = {}
            for barg, a in zip(fn.body.args, args):
                if isinstance(barg.type, (TensorType, TempType)):
                    a = jnp.asarray(a, jnp.dtype(barg.type.element))
                    want = (
                        barg.type.bounds.shape
                        if isinstance(barg.type, TempType)
                        else barg.type.shape
                    )
                    if a.shape != want:
                        raise TypeError(
                            f"@{fn.name} arg {barg.name_hint}: shape {a.shape} != "
                            f"declared {barg.type}"
                        )
                    env[barg.uid] = a
                elif isinstance(barg.type, FieldType):
                    a = jnp.asarray(a, jnp.dtype(barg.type.element))
                    env[barg.uid] = a
                    cells[barg.uid] = a
                elif isinstance(barg.type, ScalarType):
                    env[barg.uid] = jnp.asarray(
                        a, jnp_backend._scalar_dtype(barg.type)
                    )
                else:
                    env[barg.uid] = a

            outs = self._run_block(fn, env, cells)
            if outs is None:
                return None
            return outs[0] if len(outs) == 1 else tuple(outs)

        run.__name__ = f"neptune_{fn.name}"
        return run

    def _run_block(self, fn: Function, env: dict, cells: dict):
        result = None
        for op in fn.body.ops:
            result = self._eval_op(op, env, cells)
        return result

    def _eval_op(self, op: Operation, env: dict, cells: dict):
        """Evaluate one field-level op; returns terminator values if any."""
        name = op.name
        get = lambda v: env[v.uid]  # noqa: E731

        if name == "neptune.wrap":
            arr = get(op.operands[0])
            env[op.results[0].uid] = arr
            cells[op.results[0].uid] = arr
        elif name == "neptune.unwrap":
            env[op.results[0].uid] = self._cell_of(op.operands[0], env, cells)
        elif name == "neptune.load":
            env[op.results[0].uid] = self._cell_of(op.operands[0], env, cells)
        elif name == "neptune.store":
            temp = get(op.operands[0])
            field = op.operands[1]
            cur = self._cell_of(field, env, cells)
            bounds: Optional[Bounds] = op.attrs.get("bounds")
            if bounds is not None:
                ft: FieldType = field.type
                tt: TempType = op.operands[0].type
                dst = bounds.rel_slices(ft.bounds)
                src = bounds.rel_slices(tt.bounds)
                cur = cur.at[dst].set(temp[src])
            else:
                cur = jnp.asarray(temp, cur.dtype)
            self._set_cell(field, cur, cells)
        elif name == "neptune.as_tensor":
            env[op.results[0].uid] = get(op.operands[0])
        elif name == "neptune.from_tensor":
            env[op.results[0].uid] = jnp.asarray(
                get(op.operands[0]), jnp.dtype(op.results[0].type.element)
            )
        elif name == "neptune.apply":
            out = self._execute_apply(op, [get(o) for o in op.operands])
            if len(op.results) == 1:
                env[op.results[0].uid] = out
            else:
                for r, v in zip(op.results, out):
                    env[r.uid] = v
        elif name == "neptune.reduce":
            env[op.results[0].uid] = jnp_backend.execute_reduce(
                op, get(op.operands[0])
            )
        elif name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            callee = self.opdef(op.attrs["symbol"])
            outs = callee(*[get(o) for o in op.operands])
            if len(op.results) == 1:
                env[op.results[0].uid] = outs
            else:
                for r, o in zip(op.results, outs):
                    env[r.uid] = o
        elif name == "neptune.assemble_matrix":
            env[op.results[0].uid] = self._assemble(op)
        elif name == "neptune.solve_linear":
            env[op.results[0].uid] = self._solve_linear(op, env)
        elif name == "neptune.solve_nonlinear":
            self._solve_nonlinear(op, env)
        elif name == "neptune.time_advance":
            env[op.results[0].uid] = self._time_advance(op, env)
        elif name == "neptune.time_advance_runtime":
            env[op.results[0].uid] = self._time_advance_runtime(op, env)
        elif name in ("neptune.return", "neptune.yield"):
            # field-typed operands return their *current* buffer contents
            # (post-store), matching unwrap/load and the native runtime
            return [
                self._cell_of(o, env, cells)
                if isinstance(o.type, FieldType)
                else get(o)
                for o in op.operands
            ]
        elif name == "arith.constant":
            env[op.results[0].uid] = jnp.asarray(
                op.attrs["value"], jnp_backend._scalar_dtype(op.results[0].type)
            )
        elif name in jnp_backend._BINOPS:
            env[op.results[0].uid] = jnp_backend._BINOPS[name](
                get(op.operands[0]), get(op.operands[1])
            )
        elif name in jnp_backend._UNARY:
            env[op.results[0].uid] = jnp_backend._UNARY[name](get(op.operands[0]))
        elif name == "arith.cmp":
            env[op.results[0].uid] = jnp_backend._CMPS[op.attrs["pred"]](
                get(op.operands[0]), get(op.operands[1])
            )
        elif name == "arith.select":
            c, a, bb = (get(o) for o in op.operands)
            env[op.results[0].uid] = jnp.where(c, a, bb)
        elif name == "arith.cast":
            env[op.results[0].uid] = get(op.operands[0]).astype(
                jnp_backend._scalar_dtype(op.results[0].type)
            )
        else:
            raise NotImplementedError(f"executor: unhandled op {name}")
        return None

    # ------------------------------------------------------------------
    # op implementations
    # ------------------------------------------------------------------

    def _cell_of(self, field_value, env, cells):
        if field_value.uid in cells:
            return cells[field_value.uid]
        return env[field_value.uid]

    def _set_cell(self, field_value, arr, cells):
        cells[field_value.uid] = arr

    def _execute_apply(self, op: Operation, operand_arrays: Sequence):
        return jnp_backend.execute_apply(op, operand_arrays)

    def _handle_for(self, sym: str) -> MatrixHandle:
        fn = self.module.lookup(sym)
        return MatrixHandle(
            symbol=sym,
            matvec=self.opdef(sym),
            temp_type=fn.ftype.inputs[0],
            structure_key_hash=fn.attrs.get("structure_key_hash", 0),
            halo=fn.attrs.get("halo", ()),
            interior=single_apply_interior(fn),
        )

    def _assemble(self, op: Operation) -> MatrixHandle:
        return self._handle_for(op.attrs["symbol"])

    def _solve_linear(self, op: Operation, env):
        handle: MatrixHandle = env[op.operands[0].uid]
        b = env[op.operands[1].uid]
        if not isinstance(handle, MatrixHandle):
            raise TypeError("solve_linear operand 0 must be an assembled matrix handle")
        solver = op.attrs["solver"]
        tol = op.attrs["tol"]
        max_iters = op.attrs["max_iters"]
        precond = op.attrs.get("precond", "none")
        precision = op.attrs.get("precision", "full")
        from ..utils.options import merged_linear_options, split_precond_options

        opts = merged_linear_options(op.attrs.get("options"), solver)
        pc_opts = split_precond_options(opts, precond)
        if precision == "mixed":
            if op.attrs.get("options"):
                raise ValueError(
                    "precision='mixed' does not support per-solve options; "
                    "drop options= or use precision='full'"
                )
            opts = {}
            if precond in ("ssor_dense", "mg"):
                raise ValueError(
                    f"precision='mixed' does not support precond="
                    f"{precond!r}; use 'jacobi', 'ssor' (matrix-free) or "
                    "'none'"
                )
            if solver == "direct":
                raise ValueError(
                    "precision='mixed' does not support solver='direct' "
                    "(dense LU has no refinement loop); use a Krylov solver"
                )
            # f32 inner solves + f64 residual refinement (solvers.refine)
            from ..solvers.refine import refined_solve

            lo = self.low_precision_opdef(handle.symbol)
            M_lo = None
            if precond not in (None, "none"):
                like32 = jnp.zeros(handle.grid_shape, jnp.float32)
                M_lo = make_preconditioner(precond, lo, like32, handle.halo)
            x, info = refined_solve(
                handle.matvec,
                lo,
                b,
                solver=solver,
                tol=tol,
                inner_iters=max_iters,
                M_lo=M_lo,
            )
            if op.attrs.get("verbose") or profiling.verbose_default():
                jax.debug.print(
                    "[neptune] KSP({s}/mixed) {n}: rounds={r} inner={i} "
                    "resnorm={rn:.3e} converged={c}",
                    s=solver, n=handle.symbol, r=info.rounds,
                    i=info.inner_iters, rn=info.resnorm, c=info.converged,
                )
            return x
        M = None
        if precond == "mg":
            M = auto_mg_preconditioner(
                self.module, handle, self.backend, **pc_opts
            )
        elif precond not in (None, "none"):
            like = jnp.zeros(handle.grid_shape, handle.dtype)
            dense = handle.dense() if precond == "ssor_dense" else None
            M = make_preconditioner(
                precond, handle.matvec, like, handle.halo,
                dense_matrix=dense, **pc_opts,
            )
        if solver == "direct":
            if opts:
                raise ValueError(
                    "solver='direct' takes no runtime options "
                    f"(got {sorted(opts)})"
                )
            x, info = krylov.direct(handle.dense(), b)
        else:
            from ..utils.options import linear_option_kwargs

            kw = linear_option_kwargs(solver, opts)
            # Dirichlet lift (CG ONLY): nonzero boundary (copy-through
            # ring) data in b breaks CG's M-symmetry under non-uniform
            # preconditioners — see MatrixHandle.ring_lift. One matvec,
            # exact. GMRES/BiCGStab handle the nonsymmetric ring natively,
            # and the lift would shift their relative-tolerance target
            # (tol*||b - A*lift|| vs tol*||b||) away from the reference
            # runtime's, perturbing f64 golden-path agreement at ~tol.
            lift = handle.ring_lift(b) if solver == "cg" else None
            b_eff = b if lift is None else b - handle.matvec(lift)
            x, info = krylov.solve(
                handle.matvec, b_eff, solver=solver, tol=tol,
                maxiter=max_iters, M=M, **kw,
            )
            if lift is not None:
                x = x + lift
        if op.attrs.get("verbose") or profiling.verbose_default():
            profiling.report_solve(f"KSP({solver})", handle.symbol, info)
        return x

    def _solve_nonlinear(self, op: Operation, env):
        sym = op.attrs["residual"]
        n_state = op.attrs["num_states"]
        residual_fn = self.opdef(sym)
        states0 = tuple(env[o.uid] for o in op.operands[:n_state])
        captures = tuple(env[o.uid] for o in op.operands[n_state:])

        def residual(states):
            out = residual_fn(*states, *captures)
            return out if isinstance(out, tuple) else (out,)

        jac_mv = None
        jac_sym = op.attrs.get("jacobian")
        if jac_sym is not None:
            # user-supplied linearization (builder verified the signature:
            # either (v...) constant-J or (v..., u..., captures...) full form)
            jac_fn = self.opdef(jac_sym)
            n_jac_in = len(self.module.lookup(jac_sym).ftype.inputs)

            def jac_mv(u, v):
                args = tuple(v) if n_jac_in == n_state else (
                    tuple(v) + tuple(u) + captures
                )
                out = jac_fn(*args)
                return out if isinstance(out, tuple) else (out,)

        method = op.attrs["method"]
        from ..utils.options import merged_nonlinear_options, nonlinear_option_kwargs

        okw = nonlinear_option_kwargs(
            "picard" if method == "picard" else "newton",
            merged_nonlinear_options(op.attrs.get("options"), method),
        )
        if method in ("newton", "newton-krylov"):
            x, info = newton_krylov(
                residual,
                states0,
                tol=op.attrs["tol"],
                max_iters=op.attrs["max_iters"],
                krylov_tol=op.attrs.get("krylov_tol", 1e-6),
                krylov_iters=op.attrs.get("krylov_iters", 200),
                jac_mv=jac_mv,
                **okw,
            )
        elif method == "picard":
            x, info = picard(
                residual,
                states0,
                tol=op.attrs["tol"],
                max_iters=op.attrs["max_iters"],
                **okw,
            )
        else:
            raise ValueError(f"unknown nonlinear method {method!r}")
        if op.attrs.get("verbose") or profiling.verbose_default():
            profiling.report_solve(f"SNES({method})", sym, info)
        for r, v in zip(op.results, x):
            env[r.uid] = v

    def _time_advance(self, op: Operation, env):
        """Direct interpretation of time_advance. Normally the high-level pass
        (`neptune_tpu.passes.high_level`) rewrites this op away first
        (reference `lib/Passes/HighLevelConvertion.cpp:57-173`); interpreting
        it here keeps un-lowered modules executable (interpreter parity)."""
        state = env[op.operands[0].uid]
        dt = env[op.operands[1].uid]
        method = TimeMethod(op.attrs["method"])
        if method == TimeMethod.EXPLICIT:
            return self._explicit_step(op, state, dt)
        if method == TimeMethod.IMPLICIT_LINEAR:
            sym = op.attrs["system"]
            handle = self._handle_for(sym)
            M = None
            precond = op.attrs.get("precond", "none")
            if precond not in (None, "none"):
                like = jnp.zeros(handle.grid_shape, handle.dtype)
                # ssor needs the assembled matrix, exactly as in
                # _solve_linear — without it make_preconditioner raises
                dense = handle.dense() if precond == "ssor" else None
                M = make_preconditioner(
                    precond, handle.matvec, like, handle.halo,
                    dense_matrix=dense,
                )
            from ..utils.options import linear_option_kwargs, merged_linear_options

            kw = linear_option_kwargs(
                op.attrs["solver"],
                merged_linear_options(
                    op.attrs.get("options"), op.attrs["solver"]
                ),
            )
            x, info = krylov.solve(
                handle.matvec,
                state,
                solver=op.attrs["solver"],
                tol=op.attrs["tol"],
                maxiter=op.attrs["max_iters"],
                M=M,
                **kw,
            )
            return x
        if method == TimeMethod.IMPLICIT_NONLINEAR:
            sym = op.attrs["residual"]
            res_fn = self.opdef(sym)

            def residual(states):
                return (res_fn(states[0], state),)

            # forward the op's jacobian= and options= exactly like the
            # lowered solve_nonlinear path — the interpreter must not
            # solve with different Newton behavior than the same module
            # after the high-level pass
            jac_mv = None
            jac_sym = op.attrs.get("jacobian")
            if jac_sym is not None:
                jac_fn = self.opdef(jac_sym)
                n_jac_in = len(self.module.lookup(jac_sym).ftype.inputs)

                def jac_mv(u, v):
                    args = tuple(v) if n_jac_in == 1 else (
                        tuple(v) + tuple(u) + (state,)
                    )
                    out = jac_fn(*args)
                    return out if isinstance(out, tuple) else (out,)

            from ..utils.options import (
                merged_nonlinear_options,
                nonlinear_option_kwargs,
            )

            okw = nonlinear_option_kwargs(
                "newton",
                merged_nonlinear_options(op.attrs.get("options"), "newton"),
            )
            x, info = newton_krylov(
                residual,
                (state,),
                tol=op.attrs["tol"],
                max_iters=op.attrs["max_iters"],
                jac_mv=jac_mv,
                **okw,
            )
            return x[0]
        # RUNTIME: dispatch on the (traced) method scalar
        raise NotImplementedError(
            "time_advance with method=runtime must be lowered by the "
            "high-level pass to time_advance_runtime first"
        )

    def _explicit_step(self, op: Operation, state, dt):
        rhs_sym = op.attrs["rhs"]
        rhs = self.opdef(rhs_sym)
        scheme = op.attrs.get("scheme", "euler")
        if scheme == "euler":
            return state + dt * rhs(state)
        if scheme == "rk2":
            k1 = rhs(state)
            k2 = rhs(state + dt * k1)
            return state + 0.5 * dt * (k1 + k2)
        if scheme == "rk4":
            k1 = rhs(state)
            k2 = rhs(state + 0.5 * dt * k1)
            k3 = rhs(state + 0.5 * dt * k2)
            k4 = rhs(state + dt * k3)
            return state + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        raise ValueError(f"unknown explicit scheme {scheme!r}")

    def _time_advance_runtime(self, op: Operation, env):
        """lax.switch over the runtime method code. Method codes follow the
        reference *runtime* convention (`NeptunePETScRuntime.cpp:637-717`):
        0 = pass-through, 1 = copy, 2 = forward Euler — note these differ from
        the IR TimeMethod enum, a quirk SURVEY.md §2.3 records; we reproduce
        the runtime codes for the runtime op."""
        state = env[op.operands[0].uid]
        dt = env[op.operands[1].uid]
        method = jnp.asarray(env[op.operands[2].uid], jnp.int32)
        rhs_sym = op.attrs.get("rhs")
        rhs = self.opdef(rhs_sym) if rhs_sym else (lambda s: jnp.zeros_like(s))

        branches = [
            lambda s: s,  # 0: pass-through
            lambda s: s + 0.0,  # 1: copy
            lambda s: s + dt * rhs(s),  # 2: forward Euler
        ]
        return jax.lax.switch(jnp.clip(method, 0, 2), branches, state)


def single_apply_interior(fn: Function):
    """The apply bounds of a unary single-apply opdef whose copy-through
    seed is the opdef argument — the structure MatrixHandle.ring_lift
    needs ((A z)_ring = z_ring exactly). None for anything else."""
    ap = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            if ap is not None:
                return None
            ap = op
        elif op.name not in ("neptune.return", "arith.constant"):
            return None
    if ap is None or not fn.body.args:
        return None
    if not ap.operands or ap.operands[0].uid != fn.body.args[0].uid:
        return None
    return ap.attrs.get("bounds")


class _CoarseOp:
    """Minimal build_levels operand: a scaled coarse matvec + halo metadata."""

    def __init__(self, matvec, halo):
        self.matvec = matvec
        self.halo = halo

    def __call__(self, x):
        return self.matvec(x)


def auto_mg_preconditioner(
    module: Module,
    handle: MatrixHandle,
    backend: Optional[str] = None,
    *,
    mg_levels: Optional[int] = None,
    mg_smoother: str = "jacobi",
):
    """Geometric-MG preconditioner for `solve_linear(..., precond="mg")`.

    The coarse hierarchy is built automatically by 2:1 re-instantiation of
    the user's opdef (`passes.coarsen.coarsen_opdef`) with a 1/4-per-level
    matvec damping — exact rediscretization for second-order (1/h²-scaled
    or h²-absorbed) operators, the PDE-solver common case; other operator
    orders should pass an explicit hierarchy to
    `solvers.multigrid.mg_preconditioner` instead. Reference surface:
    PETSc's `-pc_type mg -pc_mg_levels N` options
    (`NeptunePETScRuntime.cpp:139-150`).

    mg_levels: total level count including the finest (default: coarsen
    while every extent stays even and the smallest stays >= 16, capped at
    6 levels). mg_smoother: "jacobi" or "cheb" (both symmetric — required
    for use inside CG; see solvers.multigrid.mg_preconditioner).
    """
    from ..passes.coarsen import coarsen_opdef
    from ..solvers.multigrid import mg_preconditioner

    shape = handle.grid_shape
    if mg_levels is None:
        mg_levels = 1
        while (
            mg_levels < 6
            and all(s % (2**mg_levels) == 0 for s in shape)
            and min(shape) // (2**mg_levels) >= 16
        ):
            mg_levels += 1
    if mg_levels < 2:
        raise ValueError(
            f"precond='mg' needs at least 2 levels (grid {shape} with "
            f"mg_levels={mg_levels}; extents must be even and >= 32 to "
            "coarsen, or pass mg_levels explicitly)"
        )
    ops: list = [handle]
    mod = module
    for lvl in range(1, mg_levels):
        mod = coarsen_opdef(mod, handle.symbol)
        mv = CompiledModule(mod, backend).opdef(handle.symbol)
        scale = 0.25**lvl  # rediscretization damping (see docstring)
        ops.append(
            _CoarseOp(lambda x, f=mv, s=scale: s * f(x), handle.halo)
        )
    like = jnp.zeros(shape, handle.dtype)
    return mg_preconditioner(ops, like, smoother=mg_smoother)


def compile_module(module: Module, backend: Optional[str] = None) -> CompiledModule:
    return CompiledModule(module, backend)
