"""neptune-opt — pass-inspection CLI.

Rebuild of the reference's `neptune-opt` (an mlir-opt clone,
`src/neptuneOpt.cpp:38-47`, workflow `README.md:33-55`): parse an IR file,
run passes, print IR after each requested stage. Additionally dumps the
jaxpr/HLO of compiled functions (the analog of inspecting the LLVM-dialect
module after `--neptuneir-to-llvm`).

Usage:
  neptune-opt FILE.ntir                          # verify + print
  neptune-opt FILE.ntir --pipeline               # all stages, final IR
  neptune-opt FILE.ntir --dump-all               # IR after every stage
  neptune-opt FILE.ntir --until high-level-convertion
  neptune-opt FILE.ntir --jaxpr entry            # jaxpr of a function
  neptune-opt FILE.ntir --hlo entry              # optimized-ready HLO text
  neptune-opt FILE.ntir --run entry --inputs a.npy b.npy   # execute
  neptune-opt FILE.ntir --run entry --native     # execute on the C++ runtime
  neptune-opt FILE.ntir --plan 4x2               # sharded plan per opdef on a
                                                 # topology-only 4x2 mesh
  neptune-opt FILE.py ...                        # run a python DSL script and
                                                 # use its traced module

Exits non-zero with the verifier error on invalid IR (the contract the
reference's negative lit tests check, e.g.
test/mlir_tests/solve-linear-invalid-system.mlir).
"""

from __future__ import annotations

import argparse
import runpy
import sys


def load_module(path: str):
    from ..ir.parser import parse_module

    if path.endswith(".py"):
        from ..frontend.core import get_context, reset_context

        reset_context()
        runpy.run_path(path, run_name="__main__")
        return get_context().module
    with open(path) as f:
        return parse_module(f.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="neptune-opt", description=__doc__)
    ap.add_argument("file", help="IR file (.ntir dump) or python DSL script")
    ap.add_argument(
        "--pipeline", action="store_true", help="run the full lowering pipeline"
    )
    ap.add_argument(
        "--dump-all", action="store_true", help="print IR after every stage"
    )
    ap.add_argument("--until", help="stop after the named stage")
    ap.add_argument("--jaxpr", metavar="FUNC", help="print the jaxpr of FUNC")
    ap.add_argument("--hlo", metavar="FUNC", help="print lowered HLO of FUNC")
    ap.add_argument("--run", metavar="FUNC", help="execute FUNC and print outputs")
    ap.add_argument(
        "--inputs", nargs="*", default=[],
        help=".npy files (or scalar literals) for --run; zeros when omitted",
    )
    ap.add_argument(
        "--native", action="store_true",
        help="execute --run on the native C++ runtime instead of JAX",
    )
    ap.add_argument(
        "--plan",
        metavar="MESH",
        help="print the sharded execution plan of every opdef over a device "
        "mesh, e.g. --plan 4x2 (topology-only: no devices needed)",
    )
    ap.add_argument("-o", "--output", help="write final IR to file")
    args = ap.parse_args(argv)

    from ..ir.ops import IRError
    from ..ir.printer import print_module
    from ..passes import run_pipeline

    try:
        module = load_module(args.file)
    except IRError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    try:
        until = args.until
        if not (
            args.pipeline or args.dump_all or until or args.jaxpr or args.hlo
            or args.run or args.plan
        ):
            until = "verify-annotate"
        pr = run_pipeline(module, until=until)
    except IRError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    final = list(pr.dumps.values())[-1]
    if args.dump_all:
        for stage, dump in pr.dumps.items():
            print(f"// ----- IR after {stage} -----")
            print(dump)
    if args.output:
        with open(args.output, "w") as f:
            f.write(final)
    elif not args.dump_all and not args.plan:
        print(final)

    if args.run:
        import numpy as np

        irfn = pr.module.lookup(args.run)
        example = []
        for i, a in enumerate(irfn.body.args):
            t = a.type
            if i < len(args.inputs):
                src = args.inputs[i]
                val = (
                    np.load(src)
                    if src.endswith(".npy")
                    else np.asarray(float(src))
                )
            elif hasattr(t, "bounds"):
                val = np.zeros(t.bounds.shape, dtype=t.element)
            elif hasattr(t, "shape"):
                val = np.zeros(t.shape, dtype=t.element)
            else:
                val = np.zeros(())
            example.append(val)
        if args.native:
            from ..runtime import NativeCompiledModule

            # pr.module is already lowered; compile it directly rather than
            # re-running the pipeline through compile_native
            out = NativeCompiledModule(pr.module).function(args.run)(*example)
        else:
            import jax

            if any(
                getattr(a.type, "element", None) == "float64"
                for a in irfn.body.args
            ):
                jax.config.update("jax_enable_x64", True)
            out = pr.compiled().function(args.run)(*example)
        outs = out if isinstance(out, tuple) else (out,)
        for j, o in enumerate(outs):
            o = np.asarray(o)
            print(
                f"// output {j}: shape={o.shape} dtype={o.dtype} "
                f"checksum={float(o.sum()):.10g}"
            )
            with np.printoptions(threshold=64, precision=6):
                print(o)

    if args.plan:
        from ..parallel import GridMesh, plan_report

        try:
            mesh_shape = tuple(int(s) for s in args.plan.split("x"))
        except ValueError:
            print(f"error: bad --plan mesh '{args.plan}' (want e.g. 4x2)",
                  file=sys.stderr)
            return 1
        gm = GridMesh(mesh_shape, abstract=True)
        cm = pr.compiled()
        for fn in pr.module.opdefs():
            print(f"// ----- sharded plan of @{fn.name} on mesh {args.plan} -----")
            try:
                print(plan_report(cm, fn.name, gm), end="")
            except ValueError as e:
                print(f"// no plan: {e}")

    if args.jaxpr or args.hlo:
        import jax
        import numpy as np

        # honor f64 modules (JAX truncates to f32 by default)
        if any(
            getattr(a.type, "element", None) == "float64"
            for f in pr.module.functions.values()
            for a in f.body.args
        ):
            jax.config.update("jax_enable_x64", True)

        cm = pr.compiled()
        name = args.jaxpr or args.hlo
        fn = cm.function(name)
        irfn = cm.module.lookup(name)
        example = []
        for a in irfn.body.args:
            t = a.type
            if hasattr(t, "bounds"):
                example.append(np.zeros(t.bounds.shape, dtype=t.element))
            elif hasattr(t, "shape"):
                example.append(np.zeros(t.shape, dtype=t.element))
            else:
                example.append(np.zeros((), dtype="float32"))
        if args.jaxpr:
            print(f"// ----- jaxpr of @{name} -----")
            print(jax.make_jaxpr(fn)(*example))
        if args.hlo:
            print(f"// ----- HLO of @{name} -----")
            print(jax.jit(fn).lower(*example).as_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
