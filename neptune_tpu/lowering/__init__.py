"""Lowering/execution layer: IR -> JAX callables (the jnp lowering)."""

from .executor import CompiledModule, compile_module

__all__ = ["CompiledModule", "compile_module"]
