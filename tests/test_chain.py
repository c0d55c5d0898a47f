"""Composite (multi-stage) opdefs — the reference's normal operator shape,
e.g. `ac_A` in `smoke_time_advance.mlir:30-60` — against the NumPy stencil
applied stage by stage: rank 2 and 3, f32 and f64, runtime scalars, torus
and mixed torus/bounded stages, coordinate-dependent bodies, the sharded
fused-composite route, and differentiation (jvp, grad) through the chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import np_oracle
from neptune_tpu.ir import (
    Bounds,
    NeptuneBuilder,
    ScalarType,
    TempType,
)
from neptune_tpu.passes import compile_ir


def _build_lap(b, tt, n, rank, name="lap", dtype="float32"):
    """5-pt (rank 2) / 7-pt (rank 3) interior Laplacian-ish opdef."""
    fn = b.make_opdef(name, "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    shape = tt.bounds.shape
    interior = Bounds.of((1,) * rank, tuple(s - 1 for s in shape))
    op, body = b.start_apply([fn.body.args[0]], interior)
    b.push_block(body)
    u = body.args[rank]
    st = ScalarType(dtype)
    s = None
    for d in range(rank):
        off_lo = [0] * rank
        off_hi = [0] * rank
        off_lo[d], off_hi[d] = -1, 1
        pair = b.add(b.access(u, off_lo), b.access(u, off_hi))
        s = pair if s is None else b.add(s, pair)
    center = b.mul(b.constant(float(2 * rank), st), b.access(u, [0] * rank))
    b.yield_(b.sub(center, s))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return fn


def lap_chain_module(n, rank=2, stages=2, dtype="float32"):
    """composite = lap(lap(...lap(x)...)), `stages` deep."""
    b = NeptuneBuilder()
    shape = (n,) * rank if rank == 2 else (32, 16, n)
    bounds = Bounds.of((0,) * rank, shape)
    tt = TempType(dtype, bounds)
    _build_lap(b, tt, n, rank, dtype=dtype)
    wf = b.make_opdef("chain", "linear_opdef", [tt], [tt])
    b.push_block(wf.body)
    y = wf.body.args[0]
    for _ in range(stages):
        y = b.apply_linear("lap", [y])
    b.return_([y])
    b.pop_block()
    return compile_ir(b.module)


def scalar_chain_module(n):
    """chain(x, w) = wjac(wjac(x, w), w): every stage takes the runtime w."""
    b = NeptuneBuilder()
    bounds = Bounds.of((0, 0), (n, n))
    tt = TempType("float32", bounds)
    st = ScalarType("float32")
    fn = b.make_opdef("wjac", "nonlinear_opdef", [tt, st], [tt])
    b.push_block(fn.body)
    interior = Bounds.of((1, 1), (n - 1, n - 1))
    op, body = b.start_apply(
        [fn.body.args[0]], interior, scalar_params=[fn.body.args[1]]
    )
    b.push_block(body)
    u, w = body.args[2], body.args[3]
    quarter = b.constant(0.25, st)
    avg = b.mul(
        quarter,
        b.add(
            b.add(b.access(u, [-1, 0]), b.access(u, [1, 0])),
            b.add(b.access(u, [0, -1]), b.access(u, [0, 1])),
        ),
    )
    b.yield_(
        b.add(b.access(u, [0, 0]), b.mul(w, b.sub(avg, b.access(u, [0, 0]))))
    )
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()

    wf = b.make_opdef("chain", "nonlinear_opdef", [tt, st], [tt])
    b.push_block(wf.body)
    y1 = b.apply_nonlinear("wjac", [wf.body.args[0], wf.body.args[1]])
    y2 = b.apply_nonlinear("wjac", [y1, wf.body.args[1]])
    b.return_([y2])
    b.pop_block()
    return compile_ir(b.module)


def periodic_chain_module(n, stages=3, mixed=False, use_index=False):
    """composite of torus (periodic, full-domain) 5-pt stages; mixed=True
    swaps the middle stage for a BOUNDED interior op (legal in one chain:
    the wrapped window rows carry true torus values, so every stage's
    per-row semantics is position-exact); use_index adds a coordinate term
    to each periodic stage, pinning the modular dim-0 iotas at wrapped rows.
    """
    b = NeptuneBuilder()
    bounds = Bounds.of((0, 0), (n, n))
    tt = TempType("float32", bounds)
    st = ScalarType("float32")

    fn = b.make_opdef("plap", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], bounds, periodic=True)
    b.push_block(body)
    u = body.args[2]
    s = b.add(
        b.add(b.access(u, [-1, 0]), b.access(u, [1, 0])),
        b.add(b.access(u, [0, -1]), b.access(u, [0, 1])),
    )
    y = b.add(
        b.mul(b.constant(0.6, st), b.access(u, [0, 0])),
        b.mul(b.constant(0.1, st), s),
    )
    if use_index:
        # + 1e-4 * i0: wrong (non-modular) coordinates at wrapped rows
        # would leak into output rows near the domain edge
        y = b.add(y, b.mul(b.constant(1e-4, st), b.cast(body.args[0], st)))
    b.yield_(y)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()

    if mixed:
        _build_lap(b, tt, n, 2, name="blap")

    wf = b.make_opdef("chain", "linear_opdef", [tt], [tt])
    b.push_block(wf.body)
    y = wf.body.args[0]
    for i in range(stages):
        callee = "blap" if (mixed and i == stages // 2) else "plap"
        y = b.apply_linear(callee, [y])
    b.return_([y])
    b.pop_block()
    return compile_ir(b.module)


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def lap_oracle(x, stages):
    lap = np_oracle.LAP5 if x.ndim == 2 else np_oracle.LAP7
    return np_oracle.sweeps(x, lap, stages, np_oracle.interior(x.shape, 1))


def wjac_oracle(x, w, stages=2):
    offs = [((0, 0), 1.0 - w)] + [(o, w / 4) for o, _ in np_oracle.LAP5[1:]]
    return np_oracle.sweeps(x, offs, stages, np_oracle.interior(x.shape, 1))


def periodic_oracle(x, stages=3, mixed=False, use_index=False):
    y = np.asarray(x, np.float64)
    ramp = 1e-4 * np.arange(x.shape[0], dtype=np.float64)[:, None]
    for i in range(stages):
        if mixed and i == stages // 2:
            y = lap_oracle(y, 1)
            continue
        y = np_oracle.apply(
            y,
            lambda r: 0.6 * r(0, 0) + 0.1 * (r(-1, 0) + r(1, 0) + r(0, -1)
                                             + r(0, 1)),
            periodic=True,
        ) + (ramp if use_index else 0.0)
    return y


class TestChainExecution:
    def test_rank2(self):
        cm = lap_chain_module(128, stages=3)
        x = _x((128, 128), 0)
        out = np.asarray(cm.opdef("chain")(x))
        np.testing.assert_allclose(out, lap_oracle(x, 3), rtol=1e-5, atol=1e-4)

    def test_rank3(self):
        cm = lap_chain_module(128, rank=3)
        x = _x((32, 16, 128), 1)
        out = np.asarray(cm.opdef("chain")(x))
        np.testing.assert_allclose(out, lap_oracle(x, 2), rtol=1e-5, atol=1e-4)

    def test_f64(self):
        cm = lap_chain_module(128, dtype="float64")
        x = _x((128, 128), 2, np.float64)
        out = np.asarray(cm.opdef("chain")(x))
        np.testing.assert_allclose(out, lap_oracle(x, 2), rtol=1e-13, atol=1e-12)

    def test_narrow_grid(self):
        cm = lap_chain_module(64)
        x = _x((64, 64), 3)
        out = np.asarray(cm.opdef("chain")(x))
        np.testing.assert_allclose(out, lap_oracle(x, 2), rtol=1e-5, atol=1e-4)

    def test_single_stage(self):
        cm = lap_chain_module(128, stages=1)
        x = _x((128, 128), 4)
        out = np.asarray(cm.opdef("chain")(x))
        np.testing.assert_allclose(out, lap_oracle(x, 1), rtol=1e-5, atol=1e-5)

    def test_runtime_scalar_threading(self):
        cm = scalar_chain_module(128)
        x = _x((128, 128), 5)
        run = cm.opdef("chain")
        for w in (0.8, 1.3):  # two values: resolved at runtime, not baked
            out = np.asarray(run(x, np.float32(w)))
            np.testing.assert_allclose(out, wjac_oracle(x, w), atol=1e-5)

    def test_jvp(self):
        # linear chain: the tangent is the chain applied to the direction
        cm = lap_chain_module(128)
        x = jnp.asarray(_x((128, 128), 6))
        v = jnp.asarray(_x((128, 128), 7))
        y, t = jax.jvp(cm.opdef("chain"), (x,), (v,))
        np.testing.assert_allclose(
            np.asarray(y), lap_oracle(np.asarray(x), 2), rtol=1e-5, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(t), lap_oracle(np.asarray(v), 2), rtol=1e-5, atol=1e-4
        )

    def test_grad_through_opdef(self):
        # grad of sum(A(u)^2) is 2 A^T A u, with A assembled densely from
        # the NumPy oracle column by column
        n = 24
        cm = lap_chain_module(n, dtype="float64")
        f = cm.opdef("chain")
        x = _x((n, n), 8, np.float64)
        g = jax.grad(lambda u: jnp.sum(f(u) ** 2))(jnp.asarray(x))
        eye = np.eye(n * n)
        A = np.stack(
            [lap_oracle(e.reshape(n, n), 2).ravel() for e in eye], axis=1
        )
        want = (2.0 * A.T @ (A @ x.ravel())).reshape(n, n)
        np.testing.assert_allclose(np.asarray(g), want, rtol=1e-10, atol=1e-9)


class TestPeriodicChain:
    @pytest.mark.parametrize(
        "mixed,use_index", [(False, False), (True, False), (False, True)],
        ids=["torus", "mixed_bounded_stage", "index_coordinates"],
    )
    def test_matches_oracle(self, mixed, use_index):
        cm = periodic_chain_module(128, stages=3, mixed=mixed,
                                   use_index=use_index)
        x = _x((128, 128), 11)
        out = np.asarray(cm.opdef("chain")(x))
        want = periodic_oracle(x, 3, mixed, use_index)
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


class TestShardedChain:
    def test_sharded_composite(self):
        # the fused-composite sharded route: zero-ghost chain on the cores,
        # band fixups restore cross-shard edges
        from neptune_tpu.parallel import GridMesh, shardmap_opdef
        from neptune_tpu.parallel.sharded_apply import plan_opdef

        n = 256
        cm = lap_chain_module(n)
        gm = GridMesh((2, 2), ("x", "y"))
        assert plan_opdef(cm, "chain", gm).kind == "fused-composite"
        f = jax.jit(shardmap_opdef(cm, "chain", gm))
        x = _x((n, n), 12)
        out = np.asarray(f(gm.shard(jnp.asarray(x))))
        np.testing.assert_allclose(out, lap_oracle(x, 2), rtol=1e-5, atol=1e-4)

    def test_sharded_runtime_scalar(self):
        from neptune_tpu.parallel import GridMesh, shardmap_opdef

        n = 256
        cm = scalar_chain_module(n)
        gm = GridMesh((2,), ("x",))
        f = jax.jit(shardmap_opdef(cm, "chain", gm))
        x = _x((n, n), 13)
        xs = gm.shard(jnp.asarray(x))
        for w in (0.8, 1.3):
            out = np.asarray(f(xs, jnp.float32(w)))
            np.testing.assert_allclose(out, wjac_oracle(x, w), atol=1e-5)
