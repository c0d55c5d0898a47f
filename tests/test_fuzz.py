"""Differential fuzzing: random stencil opdefs executed on the jnp executor
against the native C++ runtime (1e-9 on float64) and, for linear-combination
programs, against the plain NumPy stencil (`np_oracle`, 1e-5 on float32).

This is the systematic version of the review that caught the multi-slab halo
and lb-alignment divergences: random offsets, bounds, ranks, arithmetic DAGs,
selects on index predicates, and multi-input kernels.
"""

import shutil

import numpy as np
import pytest

import np_oracle
from neptune_tpu.ir import (
    BOOL,
    Bounds,
    F64,
    NeptuneBuilder,
    ScalarType,
    TempType,
)
from neptune_tpu.passes import compile_ir

HAVE_GXX = shutil.which("g++") is not None


def random_opdef(rng: np.random.Generator, case: int):
    """Build a random nonlinear opdef; returns (module, name, shape)."""
    rank = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(8, 20)) for _ in range(rank))
    lb = tuple(int(rng.integers(0, 3)) for _ in range(rank))
    bounds = Bounds.of(lb, tuple(l + s for l, s in zip(lb, shape)))
    n_in = int(rng.integers(1, 3))
    tt = TempType("float64", bounds)

    # random offsets with |o| <= 2, plus the center
    n_off = int(rng.integers(1, 5))
    offsets = [tuple(int(rng.integers(-2, 3)) for _ in range(rank)) for _ in range(n_off)]
    offsets.append((0,) * rank)
    halo = [max(abs(o[d]) for o in offsets) for d in range(rank)]
    interior = Bounds.of(
        tuple(l + h for l, h in zip(bounds.lb, halo)),
        tuple(u - h for u, h in zip(bounds.ub, halo)),
    )

    b = NeptuneBuilder()
    name = f"fuzz_{case}"
    fn = b.make_opdef(name, "nonlinear_opdef", [tt] * n_in, [tt])
    b.push_block(fn.body)
    op, body = b.start_apply(list(fn.body.args), interior)
    b.push_block(body)

    # leaf pool: accesses + constants + index casts
    pool = []
    for off in offsets:
        k = int(rng.integers(0, n_in))
        pool.append(b.access(body.args[rank + k], off))
    for _ in range(2):
        pool.append(b.constant(float(rng.uniform(-2, 2)), F64))
    pool.append(b.cast(body.args[int(rng.integers(0, rank))], F64))

    # random DAG of whitelisted scalar ops
    for _ in range(int(rng.integers(2, 8))):
        kind = rng.choice(["add", "sub", "mul", "div", "min", "max", "sel", "tanh"])
        a = pool[int(rng.integers(0, len(pool)))]
        c = pool[int(rng.integers(0, len(pool)))]
        if kind == "add":
            v = b.add(a, c)
        elif kind == "sub":
            v = b.sub(a, c)
        elif kind == "mul":
            # bound magnitudes to keep f64 vs f32-free comparison meaningful
            v = b.mul(b.unary_math("tanh", a), b.unary_math("tanh", c))
        elif kind == "div":
            v = b.div(a, b.constant(float(rng.uniform(1.0, 3.0)), F64))
        elif kind == "min":
            v = b.minimum(a, c)
        elif kind == "max":
            v = b.maximum(a, c)
        elif kind == "sel":
            iv = body.args[int(rng.integers(0, rank))]
            cond = b.cmp(
                "lt", iv, b.constant(int(rng.integers(1, 12)), iv.type)
            )
            v = b.select(cond, a, c)
        else:
            v = b.unary_math("tanh", a)
        pool.append(v)

    b.yield_(pool[-1])
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module, name, shape, n_in


@pytest.mark.parametrize("case", range(25))
def test_jnp_vs_native_random_programs(case):
    if not HAVE_GXX:
        pytest.skip("needs g++")
    rng = np.random.default_rng(1000 + case)
    module, name, shape, n_in = random_opdef(rng, case)
    inputs = [rng.standard_normal(shape) for _ in range(n_in)]

    cm = compile_ir(module, backend="jnp")
    y_jnp = np.asarray(cm.opdef(name)(*inputs))

    # native path: wrap the opdef in an exported function
    from neptune_tpu.ir import NeptuneBuilder as NB

    b = NB(module)
    fn = module.lookup(name)
    entry = b.make_function("main", "func", list(fn.ftype.inputs), list(fn.ftype.results))
    b.push_block(entry.body)
    out = b.apply_nonlinear(name, list(entry.body.args))
    b.return_([out])
    b.pop_block()

    from neptune_tpu.runtime import compile_native

    nm = compile_native(module)
    y_nat = np.asarray(nm.function("main")(*inputs))
    np.testing.assert_allclose(
        y_jnp, y_nat, atol=1e-9, err_msg=f"case {case}: jnp vs native diverged"
    )


@pytest.mark.parametrize("case", range(8))
def test_jnp_vs_numpy_random_programs(case):
    """Random f32 rank-2 linear stencils (>= 64x128) vs the NumPy stencil."""
    rng = np.random.default_rng(2000 + case)
    n0 = int(rng.integers(64, 90))
    n1 = 128
    bounds = Bounds.of((0, 0), (n0, n1))
    tt = TempType("float32", bounds)
    offsets = [
        (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))) for _ in range(3)
    ] + [(0, 0)]
    h = [max(abs(o[d]) for o in offsets) for d in (0, 1)]
    interior = Bounds.of((h[0], h[1]), (n0 - h[0], n1 - h[1]))

    b = NeptuneBuilder()
    fn = b.make_opdef("f", "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], interior)
    b.push_block(body)
    from neptune_tpu.ir import F32

    acc = None
    coefs = []
    for off in offsets:
        t = b.access(body.args[2], off)
        coefs.append((off, float(np.float32(rng.uniform(-1, 1)))))
        t = b.mul(t, b.constant(coefs[-1][1], F32))
        acc = t if acc is None else b.add(acc, t)
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()

    x = rng.standard_normal((n0, n1)).astype(np.float32)
    y_jnp = np.asarray(compile_ir(b.module, backend="jnp").opdef("f")(x))
    want = np_oracle.linear(x, coefs, np_oracle.interior(x.shape, h))
    np.testing.assert_allclose(
        y_jnp, want, atol=1e-5, err_msg=f"case {case}: jnp vs numpy diverged"
    )


@pytest.mark.parametrize("case", range(6))
def test_periodic_jnp_vs_native(case):
    """Periodic random programs: wrap semantics must agree across backends."""
    if not HAVE_GXX:
        pytest.skip("needs g++")
    rng = np.random.default_rng(3000 + case)
    rank = int(rng.integers(1, 3))
    shape = tuple(int(rng.integers(8, 16)) for _ in range(rank))
    bounds = Bounds.of((0,) * rank, shape)
    tt = TempType("float64", bounds)
    offsets = [
        tuple(int(rng.integers(-2, 3)) for _ in range(rank)) for _ in range(3)
    ]

    b = NeptuneBuilder()
    fn = b.make_opdef("p", "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], bounds, periodic=True)
    b.push_block(body)
    acc = None
    for off in offsets:
        t = b.mul(
            b.access(body.args[rank], off),
            b.constant(float(rng.uniform(-1, 1)), F64),
        )
        acc = t if acc is None else b.add(acc, t)
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()

    entry = b.make_function("main", "func", [tt], [tt])
    b.push_block(entry.body)
    out = b.apply_nonlinear("p", [entry.body.args[0]])
    b.return_([out])
    b.pop_block()

    x = rng.standard_normal(shape)
    y_jnp = np.asarray(compile_ir(b.module, backend="jnp").opdef("p")(x))

    from neptune_tpu.runtime import compile_native

    y_nat = np.asarray(compile_native(b.module).function("main")(x))
    np.testing.assert_allclose(
        y_jnp, y_nat, atol=1e-10, err_msg=f"periodic case {case} diverged"
    )


def _tanh_stencil_module(name, n0, n1, rng, h_min0=0, extra=()):
    """Random f32 rank-2 opdef sum_c c * tanh(x[off]); returns the module,
    (offset, coef) terms and reach."""
    from neptune_tpu.ir import F32

    bounds = Bounds.of((0, 0), (n0, n1))
    tt = TempType("float32", bounds)
    n_off = int(rng.integers(2, 5))
    offsets = [
        (int(rng.integers(-2, 3)), int(rng.integers(-2, 3)))
        for _ in range(n_off)
    ] + [(0, 0), *extra]
    h = [max(abs(o[d]) for o in offsets) for d in (0, 1)]
    if h[0] < h_min0:
        offsets.append((1, 0))
        h[0] = 1
    interior = Bounds.of((h[0], h[1]), (n0 - h[0], n1 - h[1]))

    b = NeptuneBuilder()
    fn = b.make_opdef(name, "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], interior)
    b.push_block(body)
    acc = None
    terms = []
    for off in offsets:
        # tanh-bounded terms keep K-fold f32 accumulation comparable
        terms.append((off, float(np.float32(rng.uniform(-0.3, 0.3)))))
        t = b.mul(
            b.unary_math("tanh", b.access(body.args[2], off)),
            b.constant(terms[-1][1], F32),
        )
        acc = t if acc is None else b.add(acc, t)
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module, terms, h


def _tanh_sweeps_oracle(x, terms, h, k):
    box = np_oracle.interior(x.shape, h)
    y = np.asarray(x, np.float64)
    for _ in range(k):
        y = np_oracle.apply(
            y, lambda r: sum(c * np.tanh(r(*o)) for o, c in terms), box
        )
    return y


@pytest.mark.parametrize("case", range(8))
def test_multisweep_vs_loop_random_programs(case):
    """Random operators: cm.sweeps(k) must equal K NumPy steps."""
    rng = np.random.default_rng(4000 + case)
    n0 = int(rng.choice([64, 96, 128]))
    n1 = int(rng.choice([128, 256]))
    k = int(rng.integers(2, 9))
    module, terms, h = _tanh_stencil_module("ms", n0, n1, rng, h_min0=1)
    x = rng.standard_normal((n0, n1)).astype(np.float32)
    y = np.asarray(compile_ir(module).sweeps("ms", k)(x))
    np.testing.assert_allclose(
        y, _tanh_sweeps_oracle(x, terms, h, k), atol=1e-5,
        err_msg=f"case {case}: k={k} sweeps diverged (h={h})",
    )


@pytest.mark.parametrize("case", range(8))
def test_two_level_window_random_programs(case):
    """Random operators over wide rows (1024-2048) at depths 4-9: the
    shapes that once took the two-level window; K NumPy steps as oracle."""
    rng = np.random.default_rng(5000 + case)
    n0 = int(rng.choice([128, 256]))
    n1 = int(rng.choice([1024, 1536, 2048]))
    k = int(rng.integers(4, 10))
    module, terms, h = _tanh_stencil_module("tl", n0, n1, rng, extra=[(1, 0)])
    x = rng.standard_normal((n0, n1)).astype(np.float32)
    y = np.asarray(compile_ir(module).sweeps("tl", k)(x))
    np.testing.assert_allclose(
        y, _tanh_sweeps_oracle(x, terms, h, k), atol=1e-5,
        err_msg=f"case {case}: k={k} sweeps diverged (h={h}, n=({n0},{n1}))",
    )
