"""The staged lowering pipeline with per-stage IR dumps.

Analog of the reference's `neptuneir-to-llvm` pipeline
(`lib/Pipeline/NeptuneIRPassesPipeline.cpp:5-53`):

    reference                          this build
    ---------                          ----------
    neptune-ir-verify-annotate     ->  verify_and_annotate     (ir.verify)
    neptune-ir-high-level-convertion-> convert_time_advance    (passes.high_level)
    neptune-ir-structure-lowering  ->  opdef -> cached traced callables
                                       (lowering.executor, done lazily)
    neptune-ir-runtime-lowering    ->  solver-op dispatch into solvers/
                                       (lowering.executor)
    neptune-ir-dataflow-lowering   ->  apply -> jnp (lowering.jnp_backend)
    LLVM codegen + AOT cache       ->  jax.jit + persistent XLA cache

Each stage records an IR dump, preserving the reference's `neptune-opt`
per-pass inspection workflow (`README.md:46-55`). The final "stage" for
inspection purposes is the jaxpr of a compiled entry point
(`CompiledModule.function` + `jax.make_jaxpr`), the analog of dumping the
LLVM dialect module.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..config import config
from ..ir.core import Module
from ..ir.printer import print_module
from ..ir.verify import verify_and_annotate
from ..lowering.executor import CompiledModule
from .high_level import convert_time_advance

STAGES: tuple[tuple[str, Callable[[Module], Module]], ...] = (
    ("verify-annotate", verify_and_annotate),
    ("high-level-convertion", convert_time_advance),
    # re-verify: the rewrite introduced new applies needing shape annotations
    ("post-convert-verify", verify_and_annotate),
)


class PipelineResult:
    def __init__(self, module: Module, dumps: dict[str, str]):
        self.module = module
        self.dumps = dumps

    def compiled(self, backend: Optional[str] = None) -> CompiledModule:
        return CompiledModule(self.module, backend)


def run_pipeline(
    module: Module,
    *,
    until: Optional[str] = None,
    clone: bool = True,
    collect_dumps: bool = True,
) -> PipelineResult:
    """Run the lowering pipeline, optionally stopping after stage `until`.

    With clone=True the input module is left untouched (so a frontend can keep
    tracing into it while compiled snapshots execute).
    """
    if until is not None and until not in {name for name, _ in STAGES}:
        raise ValueError(
            f"unknown pipeline stage {until!r}; stages: "
            + ", ".join(name for name, _ in STAGES)
        )
    m = module.clone() if clone else module
    dumps: dict[str, str] = {}
    if collect_dumps:
        dumps["input"] = print_module(m)
    for name, stage in STAGES:
        m = stage(m)
        if collect_dumps:
            dumps[name] = print_module(m)
        if config.dump_ir:
            print(f"// ----- IR after {name} -----")
            print(dumps.get(name) or print_module(m))
        if until == name:
            break
    return PipelineResult(m, dumps)


def compile_ir(module: Module, backend: Optional[str] = None) -> CompiledModule:
    """One-call lowering: pipeline + executor."""
    return run_pipeline(module).compiled(backend)
