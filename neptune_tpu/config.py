"""Global configuration for neptune_tpu.

The reference layers its configuration across CMake options, build-script flags,
MLIR pass options, per-op attributes, and PETSc option strings (see SURVEY.md §5,
reference `include/Passes/NeptuneIRPasses.td:44-85`,
`lib/Runtime/PETSc/NeptunePETScRuntime.cpp:139-143`). Here the equivalent is a
single process-wide config object plus per-op attributes on the IR ops, with
environment-variable overrides.

Environment variables:
  NEPTUNE_TPU_BACKEND        "auto" | "jnp"   (default "auto"; the same lowering)
  NEPTUNE_TPU_X64            "1" to enable float64 in JAX (tests enable this)
  JAX_COMPILATION_CACHE_DIR  persistent XLA compilation cache dir (default
                             `<checkout>/.jax_cache`, see setup_persistent_cache)
  NEPTUNE_TPU_CACHE_DIR      native `.so` cache dir (runtime/aot.py; mirrors the
                             reference's NEPTUNE_CACHE_DIR, backend.py:15-19)
  NEPTUNE_TPU_DUMP_IR        "1" to print IR after every pipeline stage
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

# Fixed so that every process of one checkout finds the same cache: the
# directory is part of the cache's key.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


@dataclasses.dataclass
class Config:
    # Apply-executor backend: "jnp" (the XLA lowering) or "auto" (the same).
    # Anything else raises in CompiledModule.
    backend: str = os.environ.get("NEPTUNE_TPU_BACKEND", "auto")

    # Default element dtype for fields when the frontend does not specify one.
    # The reference is f64-only (`NeptuneIRTypes.td` uses f64 throughout its
    # tests).
    default_dtype: str = os.environ.get("NEPTUNE_TPU_DTYPE", "float64")

    # Print IR after each pipeline stage (the `neptune-opt` single-pass
    # inspection workflow, reference README.md:46-55).
    dump_ir: bool = os.environ.get("NEPTUNE_TPU_DUMP_IR", "0") == "1"

    # Pinned-arithmetic reproducibility mode: make GSPMD-sharded solves
    # BITWISE identical across mesh shapes (BASELINE.md "bit-stable
    # convergence"; SURVEY §7 hard part (b)). Two layout-dependent compiler
    # freedoms are removed at trace time:
    #   * FMA contraction — every arith.mul in an apply body (and the
    #     axpy updates inside the Krylov iterations) is fenced with
    #     lax.optimization_barrier, so mul+add can never contract into an
    #     FMA whose placement depends on the local tile shape;
    #   * reduction association — tdot/tnorm sum through a fixed
    #     pairwise-halving tree over the flat global vector (log2 N
    #     elementwise adds), so the association order is a function of the
    #     global element order only, never of the shard layout.
    # Off by default: the barriers block kernel fusion (extra HBM traffic)
    # and the pairwise tree costs log2(N) passes vs 1. jnp/GSPMD paths
    # only; the shard_map fused paths (ca_*, shardmap_*) are performance
    # paths and keep default arithmetic.
    pinned_arithmetic: bool = os.environ.get("NEPTUNE_TPU_PINNED", "0") == "1"

    # Affine folding: collapse constant-coefficient linear combinations of
    # stencil accesses into one coefficient-folded FMA chain at lowering
    # time (the classic stencil strength reduction: the traced form of a
    # 4th-order derivative carries divisions and nested multiply chains —
    # 19 elementwise block ops for the advection body — that fold to 8
    # FMAs with exact python-float coefficient arithmetic). Applied
    # uniformly by every non-pinned lowering (whole-array and shard_map
    # locals), so parity comparisons see identical arithmetic; pinned mode
    # keeps the traced op order untouched.
    fold_affine: bool = os.environ.get("NEPTUNE_TPU_FOLD_AFFINE", "1") == "1"


config = Config()


def enable_x64() -> None:
    """Enable float64 in JAX. Must run before any JAX computation.

    The reference computes exclusively in f64 (PETSc scalars); tests use this
    to validate 1e-10 agreement with NumPy/SciPy oracles.
    """
    import jax

    jax.config.update("jax_enable_x64", True)


def setup_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory:
    JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself, and no other
    directory is set here), else `<checkout>/.jax_cache`.

    The analog of the reference's AOT kernel cache keyed by IR hash
    (`python_frontend/neptune/backend.py:26-87`): XLA keys on HLO hash.
    """
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = str(DEFAULT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache)
    return cache


if os.environ.get("NEPTUNE_TPU_X64", "0") == "1":
    enable_x64()
