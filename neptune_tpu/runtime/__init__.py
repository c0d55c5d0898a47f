"""Native host runtime: C++ codegen + AOT cache + ctypes loading.

The native analog of the reference's compiled-kernel + PETSc-runtime path
(`lib/Compiler/NeptuneCompiler.cpp` AOT backend + `lib/Runtime/PETSc/`):
stencil applies compile to C++ loop nests, solver ops call the
libneptune_rt Krylov/Newton implementations, modules cache as shared
objects keyed by source hash and load through ctypes. Serves as the
double-precision host oracle, chosen explicitly (never as a fallback).
"""

from .aot import NativeCompiledModule, compile_native
from .cgen import CodegenError, generate_cpp

__all__ = [
    "NativeCompiledModule",
    "compile_native",
    "CodegenError",
    "generate_cpp",
]
