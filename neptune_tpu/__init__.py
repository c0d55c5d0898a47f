"""neptune_tpu — stencil-compiler framework for PDE solvers on JAX/XLA.

A JAX implementation with the capabilities of the
`levia-than/neptune-pde-solver` reference (an MLIR stencil DSL + PETSc
runtime): a Python-traced stencil IR (fields/temps with bounds, grid-location
and stencil-shape metadata; wrap/unwrap, load/store, apply/access/yield,
reduce, linear/nonlinear operator definitions, solve and time-advance ops)
lowering to fused XLA kernels, with matrix-free Krylov and
Newton–Krylov solvers replacing PETSc KSP/SNES, and shard_map halo exchange
for multi-chip meshes.

Layers (bottom-up; see SURVEY.md for the reference mapping):
  neptune_tpu.ir        — types, attrs, ops, verifier, structure keys
  neptune_tpu.passes    — high-level conversion + staged pipeline with dumps
  neptune_tpu.lowering  — executor: the jnp lowering XLA compiles
  neptune_tpu.solvers   — CG/BiCGStab/GMRES, Jacobi/SSOR, Newton–Krylov
  neptune_tpu.parallel  — device meshes, sharded fields, halo exchange
  neptune_tpu.frontend  — user DSL: Expr tracing, decorators, jit_class
"""

from . import config as _config_mod
from .config import config, enable_x64

# the reference package surface (`python_frontend/neptune/__init__.py:11-44`)
# plus this build's extensions (nonlinear_op_def, solve_nonlinear, reduce,
# time_advance, temp, math functions, where/index)
from .frontend import (
    CompiledLibrary,
    Context,
    Expr,
    GlobalContext,
    MatrixExpr,
    OpDef,
    apply,
    assemble_matrix,
    get_compiler,
    get_context,
    index,
    interior,
    on_boundary,
    jit_class,
    jit_compile,
    linear_op_def,
    nonlinear_op_def,
    reduce,
    reset_context,
    solve_linear,
    sweeps,
    solve_nonlinear,
    stencil,
    temp,
    time_advance,
    where,
)
from .frontend import abs, cos, erf, exp, log, maximum, minimum, sin, sqrt, tanh
from .ir.types import Bounds, Location, StencilShape, TempType, TimeMethod
from .solvers.diff import differentiable_root, differentiable_solve
from .solvers.time import simulate

__version__ = "0.1.0"

__all__ = [
    "config",
    "enable_x64",
    "__version__",
    "CompiledLibrary",
    "Context",
    "Expr",
    "GlobalContext",
    "MatrixExpr",
    "OpDef",
    "apply",
    "assemble_matrix",
    "get_compiler",
    "get_context",
    "index",
    "interior",
    "on_boundary",
    "jit_class",
    "jit_compile",
    "linear_op_def",
    "nonlinear_op_def",
    "reduce",
    "reset_context",
    "solve_linear",
    "sweeps",
    "solve_nonlinear",
    "stencil",
    "temp",
    "time_advance",
    "where",
    "abs",
    "cos",
    "erf",
    "exp",
    "log",
    "maximum",
    "minimum",
    "sin",
    "sqrt",
    "tanh",
    "Bounds",
    "Location",
    "StencilShape",
    "TempType",
    "TimeMethod",
    "simulate",
    "differentiable_root",
    "differentiable_solve",
]
