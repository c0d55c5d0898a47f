"""Trailing scalar opdef args in the sharded (fused) execution paths, and
the composite-chain main sweep.

VERDICT r2 item #4 residue: scalar-arg opdefs (a runtime dt, a relaxation
weight) were unsupported in all fused paths, and composite chains ran
jnp-only main sweeps. Scalars are replicated (pspec()) and resolved from
the call at trace time (`_ScalarArg` markers in the plan); the oracle is
the non-sharded executor at the SAME scalar value — and a second scalar
value proves the value is threaded at runtime, not baked."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neptune_tpu as ntp
import np_oracle
from neptune_tpu.ir import Bounds, F64, NeptuneBuilder, ScalarType, TempType
from neptune_tpu.parallel import GridMesh, shardmap_opdef, shardmap_sweeps
from neptune_tpu.parallel.sharded_apply import plan_opdef
from neptune_tpu.passes import compile_ir

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(autouse=True)
def fresh():
    ntp.reset_context()
    yield
    ntp.reset_context()


def scalar_jacobi_module(n, dtype="float64"):
    """op(u, w) = w-weighted 5-pt average over the interior."""
    b = NeptuneBuilder()
    bounds = Bounds.of((0, 0), (n, n))
    tt = TempType(dtype, bounds)
    st = ScalarType(dtype)
    fn = b.make_opdef("wjac", "nonlinear_opdef", [tt, st], [tt])
    b.push_block(fn.body)
    interior = Bounds.of((1, 1), (n - 1, n - 1))
    op, body = b.start_apply(
        [fn.body.args[0]], interior, scalar_params=[fn.body.args[1]]
    )
    b.push_block(body)
    u = body.args[2]
    w = body.args[3]
    quarter = b.constant(0.25, ScalarType(dtype))
    avg = b.mul(
        quarter,
        b.add(
            b.add(b.access(u, [-1, 0]), b.access(u, [1, 0])),
            b.add(b.access(u, [0, -1]), b.access(u, [0, 1])),
        ),
    )
    # u + w*(avg - u): weighted Jacobi
    b.yield_(b.add(b.access(u, [0, 0]), b.mul(w, b.sub(avg, b.access(u, [0, 0])))))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return compile_ir(b.module)


class TestScalarArgs:
    def test_single_apply_runtime_scalar(self):
        n = 64
        cm = scalar_jacobi_module(n)
        gm = GridMesh((4, 2), ("x", "y"))
        f = jax.jit(shardmap_opdef(cm, "wjac", gm))
        x = np.random.default_rng(0).standard_normal((n, n))
        xs = gm.shard(jnp.asarray(x))
        for w in (0.8, 1.3):  # two values: resolved at runtime, not baked
            out = np.asarray(f(xs, jnp.float64(w)))
            ref = np.asarray(cm.opdef("wjac")(x, w))
            np.testing.assert_allclose(out, ref, atol=1e-13)

    def test_sweeps_runtime_scalar(self):
        n = 64
        k = 3
        cm = scalar_jacobi_module(n)
        gm = GridMesh((4, 2), ("x", "y"))
        f = jax.jit(shardmap_sweeps(cm, "wjac", gm, k))
        x = np.random.default_rng(1).standard_normal((n, n))
        for w in (0.7, 1.1):
            out = np.asarray(f(gm.shard(jnp.asarray(x)), jnp.float64(w)))
            ref = x
            for _ in range(k):
                ref = np.asarray(cm.opdef("wjac")(ref, w))
            np.testing.assert_allclose(out, ref, atol=1e-12)

    def test_composite_runtime_scalar(self):
        # ac_A-style chain where every stage takes the runtime scalar:
        # wrapped(x, w) = wjac(wjac(x, w), w) — composed reach 2
        n = 64
        b = NeptuneBuilder()
        bounds = Bounds.of((0, 0), (n, n))
        tt = TempType("float64", bounds)
        st = ScalarType("float64")
        _build_wjac_into(b, tt, st, n)
        fn = b.make_opdef("wrapped", "nonlinear_opdef", [tt, st], [tt])
        b.push_block(fn.body)
        y1 = b.apply_nonlinear("wjac", [fn.body.args[0], fn.body.args[1]])
        y2 = b.apply_nonlinear("wjac", [y1, fn.body.args[1]])
        b.return_([y2])
        b.pop_block()
        cm = compile_ir(b.module)
        assert cm.module.lookup("wrapped").attrs["halo"] == ((2, 2), (2, 2))

        gm = GridMesh((4, 2), ("x", "y"))
        f = jax.jit(shardmap_opdef(cm, "wrapped", gm))
        x = np.random.default_rng(2).standard_normal((n, n))
        for w in (0.9, 0.5):
            out = np.asarray(f(gm.shard(jnp.asarray(x)), jnp.float64(w)))
            ref = np.asarray(cm.opdef("wrapped")(x, w))
            np.testing.assert_allclose(out, ref, atol=1e-12)

    def test_interleaved_args_rejected(self):
        # the sharded paths require trailing scalars; the IR builder already
        # enforces it at opdef construction, so no malformed signature can
        # reach shardmap_opdef's own check
        from neptune_tpu.ir.ops import IRError

        n = 16
        b = NeptuneBuilder()
        tt = TempType("float64", Bounds.of((0, 0), (n, n)))
        st = ScalarType("float64")
        with pytest.raises(IRError, match="trailing scalars"):
            b.make_opdef("bad", "nonlinear_opdef", [st, tt], [tt])


def _build_wjac_into(b, tt, st, n):
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
    b.yield_(b.add(b.access(u, [0, 0]), b.mul(w, b.sub(avg, b.access(u, [0, 0])))))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()


class TestCompositeMainSweep:
    def test_composite_chain(self):
        # f32 composite lap(lap(x)) on the fused-composite sharded route vs
        # the NumPy stencil applied twice
        n = 128
        b = NeptuneBuilder()
        bounds = Bounds.of((0, 0), (n, n))
        tt = TempType("float32", bounds)
        fn = b.make_opdef("lap", "linear_opdef", [tt], [tt])
        b.push_block(fn.body)
        interior = Bounds.of((1, 1), (n - 1, n - 1))
        op, body = b.start_apply([fn.body.args[0]], interior)
        b.push_block(body)
        u = body.args[2]
        from neptune_tpu.ir import F32

        s = b.add(
            b.add(b.access(u, [-1, 0]), b.access(u, [1, 0])),
            b.add(b.access(u, [0, -1]), b.access(u, [0, 1])),
        )
        b.yield_(
            b.sub(
                b.mul(b.constant(4.0, F32), b.access(u, [0, 0])),
                s,
            )
        )
        b.pop_block()
        b.return_([b.finish_apply(op)])
        b.pop_block()

        wf = b.make_opdef("lap2", "linear_opdef", [tt], [tt])
        b.push_block(wf.body)
        y1 = b.apply_linear("lap", [wf.body.args[0]])
        y2 = b.apply_linear("lap", [y1])
        b.return_([y2])
        b.pop_block()
        cm = compile_ir(b.module)

        gm = GridMesh((2,), ("x",), devices=jax.devices()[:2])
        assert plan_opdef(cm, "lap2", gm).kind == "fused-composite"
        x = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
        out = np.asarray(
            jax.jit(shardmap_opdef(cm, "lap2", gm))(gm.shard(jnp.asarray(x)))
        )
        ref = np_oracle.sweeps(x, np_oracle.LAP5, 2, np_oracle.interior(x.shape, 1))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
