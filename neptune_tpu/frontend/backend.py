"""jit_compile — whole-module compilation (the reference AOT path).

The reference's `AOTCompiler.compile_and_load` (`python_frontend/neptune/
backend.py:11-93`) hashes the module IR, AOT-compiles to a cached `.so`, and
returns a ctypes CDLL whose attributes are the compiled entry points. Here the
analog is: run the lowering pipeline, wrap every traced function in `jax.jit`,
and return a library object with the same attribute-access surface. Kernel
caching maps onto JAX's persistent compilation cache (keyed by HLO hash, the
analog of the reference's SHA-256-of-IR key), set up by
`config.setup_persistent_cache`.
"""

from __future__ import annotations

import jax

from ..config import setup_persistent_cache
from .core import GlobalContext, get_context


class CompiledLibrary:
    """Attribute-access façade over a pipeline-compiled module
    (the `ctypes.CDLL` stand-in)."""

    def __init__(self, compiled_module):
        self._cm = compiled_module
        self._jitted: dict[str, object] = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._jitted:
            try:
                fn = self._cm.function(name)
            except KeyError:
                raise AttributeError(f"no compiled function @{name}")
            self._jitted[name] = jax.jit(fn)
        return self._jitted[name]

    def function_names(self):
        return [f.name for f in self._cm.module.funcs()]

    @property
    def module(self):
        return self._cm.module


def jit_compile(compiler_instance: GlobalContext | None = None) -> CompiledLibrary:
    """Compile the context's module; returns a library of jitted functions
    (reference `jit_compile(compiler)`, backend.py:96-98)."""
    ctx = compiler_instance or get_context()
    setup_persistent_cache()
    return CompiledLibrary(ctx.compiled())
