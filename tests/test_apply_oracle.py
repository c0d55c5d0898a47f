"""One `cm.opdef` apply per operator and shape against the plain NumPy
stencil (`np_oracle`): the XLA lowering's semantics at the shapes the old
kernel tests covered — wide reach, rank 3, multi-input, index predicates,
rank 1, bf16, and the sharded fused-strip route — plus the backend choice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neptune_tpu as ntp
import np_oracle
from neptune_tpu.config import config
from neptune_tpu.lowering.executor import CompiledModule
from neptune_tpu.passes import compile_ir


@pytest.fixture(autouse=True)
def fresh():
    ntp.reset_context()
    yield
    config.backend = "auto"
    ntp.reset_context()


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _adv4(n, m, dtype, name):
    @ntp.nonlinear_op_def(
        bounds=([0, 0], [n, m]), interior=([2, 2], [n - 2, m - 2]),
        dtype=dtype, name=name,
    )
    def adv4(u):
        dudx = (-u[2, 0] + 8.0 * u[1, 0] - 8.0 * u[-1, 0] + u[-2, 0]) / 12.0
        dudy = (-u[0, 2] + 8.0 * u[0, 1] - 8.0 * u[0, -1] + u[0, -2]) / 12.0
        return u[0, 0] - 0.1 * (0.7 * dudx + 0.3 * dudy)

    return adv4


def _heat3(m, w, name):
    @ntp.linear_op_def(
        bounds=([0, 0, 0], [m, m, w]),
        interior=([1, 1, 1], [m - 1, m - 1, w - 1]),
        dtype="float32", name=name,
    )
    def heat3(u):
        return u[0, 0, 0] + 0.1 * (
            u[-1, 0, 0] + u[1, 0, 0] + u[0, -1, 0]
            + u[0, 1, 0] + u[0, 0, -1] + u[0, 0, 1]
            - 6.0 * u[0, 0, 0]
        )

    return heat3


HEAT3 = [((0, 0, 0), 0.4)] + [(o, 0.1) for o, _ in np_oracle.LAP7[1:]]


class TestApplyOracle:
    def test_2d_5pt(self):
        @ntp.linear_op_def(
            bounds=([0, 0], [64, 128]), interior=([1, 1], [63, 127]),
            dtype="float32",
        )
        def lap(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        x = _x((64, 128), 0)
        want = np_oracle.linear(x, np_oracle.LAP5, np_oracle.interior(x.shape, 1))
        np.testing.assert_allclose(np.asarray(lap(x)), want, atol=1e-5)

    def test_2d_wide_offsets(self):
        @ntp.linear_op_def(
            bounds=([0, 0], [64, 128]), interior=([2, 2], [62, 126]),
            dtype="float32",
        )
        def wide(u):
            return (
                -u[-2, 0] + 8.0 * u[-1, 0] - 8.0 * u[1, 0] + u[2, 0]
                - u[0, -2] + 8.0 * u[0, -1] - 8.0 * u[0, 1] + u[0, 2]
            ) / 12.0

        x = _x((64, 128), 1)
        offs = [((s, 0), c / 12.0) for s, c in ((-2, -1), (-1, 8), (1, -8), (2, 1))]
        offs += [((0, s), c) for (s, _), c in offs]
        want = np_oracle.linear(x, offs, np_oracle.interior(x.shape, 2))
        np.testing.assert_allclose(np.asarray(wide(x)), want, atol=1e-5)

    def test_3d_7pt(self):
        heat = _heat3(16, 128, "heat")
        x = _x((16, 16, 128), 2)
        want = np_oracle.linear(x, HEAT3, np_oracle.interior(x.shape, 1))
        np.testing.assert_allclose(np.asarray(heat(x)), want, atol=1e-5)

    def test_multi_input(self):
        @ntp.nonlinear_op_def(
            bounds=([0, 0], [64, 128]), interior=([1, 1], [63, 127]),
            dtype="float32",
        )
        def combine(u, v):
            return u[0, 0] * v[0, 0] + u[-1, 0] - v[0, 1]

        x, y = _x((64, 128), 3), _x((64, 128), 4)
        sv = np_oracle.shift(y.astype(np.float64), (0, 1))
        want = np_oracle.apply(
            x, lambda r: r(0, 0) * y + r(-1, 0) - sv,
            np_oracle.interior(x.shape, 1),
        )
        np.testing.assert_allclose(np.asarray(combine(x, y)), want, atol=1e-5)

    def test_index_dependent_boundary(self):
        @ntp.nonlinear_op_def(bounds=([0, 0], [64, 128]), dtype="float32")
        def bc(u):
            i = ntp.index(0)
            j = ntp.index(1)
            edge = (i == 0) | (i == 63) | (j == 0) | (j == 127)
            return ntp.where(edge, u[0, 0], 0.25 * (
                u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1]
            ))

        x = _x((64, 128), 5)
        want = np_oracle.linear(
            x, [((-1, 0), .25), ((1, 0), .25), ((0, -1), .25), ((0, 1), .25)],
            np_oracle.interior(x.shape, 1),
        )
        np.testing.assert_allclose(np.asarray(bc(x)), want, atol=1e-5)

    def test_rank1(self):
        @ntp.linear_op_def(bounds=([0], [256]), interior=([1], [255]))
        def lap1(u):
            return 2.0 * u[0] - u[-1] - u[1]

        x = _x((256,), 6, np.float64)
        want = np_oracle.linear(
            x, [((0,), 2.0), ((-1,), -1.0), ((1,), -1.0)], ((1,), (255,))
        )
        np.testing.assert_allclose(np.asarray(lap1(x)), want, atol=1e-12)

    def test_bf16(self):
        @ntp.linear_op_def(
            bounds=([0, 0], [64, 128]), interior=([1, 1], [63, 127]),
            dtype="bfloat16",
        )
        def jac(u):
            return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

        x = _x((64, 128), 7).astype("bfloat16")
        want = np_oracle.linear(
            x.astype(np.float32),
            [((-1, 0), .25), ((1, 0), .25), ((0, -1), .25), ((0, 1), .25)],
            np_oracle.interior(x.shape, 1),
        )
        got = np.asarray(jac(x)).astype(np.float32)
        np.testing.assert_allclose(got, want, atol=3e-2)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_adv4(self, dtype):
        op = _adv4(64, 128, dtype, "adv4")
        x = jnp.asarray(_x((64, 128), 8), jnp.dtype(dtype))
        xh = np.asarray(x, np.float32)
        want = np_oracle.linear(xh, np_oracle.ADV4, np_oracle.interior(xh.shape, 2))
        got = np.asarray(op(x), np.float32)
        np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32" else 5e-2)

    def test_rank3_heat(self):
        heat3 = _heat3(32, 128, "heat3")
        x = _x((32, 32, 128), 9)
        want = np_oracle.linear(x, HEAT3, np_oracle.interior(x.shape, 1))
        np.testing.assert_allclose(np.asarray(heat3(x)), want, atol=1e-5)

    def test_rank3_wide_dim0(self):
        m = 64

        @ntp.nonlinear_op_def(
            bounds=([0, 0, 0], [m, m, m]),
            interior=([18, 1, 1], [m - 18, m - 1, m - 1]),
            dtype="float32", name="wide0",
        )
        def wide0(u):
            return u[-18, 0, 0] + u[18, 0, 0]

        x = _x((m, m, m), 10)
        want = np_oracle.linear(
            x, [((-18, 0, 0), 1.0), ((18, 0, 0), 1.0)],
            ((18, 1, 1), (m - 18, m - 1, m - 1)),
        )
        np.testing.assert_allclose(np.asarray(wide0(x)), want, atol=1e-5)


class TestApplyOracleEdges:
    """Ragged shapes, dtypes, periodicity, scalar operands, pinned
    arithmetic and differentiation of one apply, against NumPy."""

    @pytest.mark.parametrize("n,m", [(20, 300), (7, 33)])
    def test_adv4_ragged(self, n, m):
        op = _adv4(n, m, "float32", f"adv4_{n}x{m}")
        x = _x((n, m), 30)
        want = np_oracle.linear(x, np_oracle.ADV4, np_oracle.interior(x.shape, 2))
        np.testing.assert_allclose(np.asarray(op(x)), want, atol=1e-5)

    def test_adv4_f64(self):
        op = _adv4(64, 128, "float64", "adv4d")
        x = _x((64, 128), 31, np.float64)
        want = np_oracle.linear(x, np_oracle.ADV4, np_oracle.interior(x.shape, 2))
        np.testing.assert_allclose(np.asarray(op(x)), want, atol=1e-13)

    def test_adv4_periodic(self):
        @ntp.nonlinear_op_def(bounds=([0, 0], [32, 64]), dtype="float64",
                              periodic=True, name="adv4p")
        def adv4p(u):
            dudx = (-u[2, 0] + 8.0 * u[1, 0] - 8.0 * u[-1, 0] + u[-2, 0]) / 12.0
            dudy = (-u[0, 2] + 8.0 * u[0, 1] - 8.0 * u[0, -1] + u[0, -2]) / 12.0
            return u[0, 0] - 0.1 * (0.7 * dudx + 0.3 * dudy)

        x = _x((32, 64), 32, np.float64)
        want = np_oracle.linear(x, np_oracle.ADV4, periodic=True)
        np.testing.assert_allclose(np.asarray(adv4p(x)), want, atol=1e-13)

    def test_rank3_mixed_reach(self):
        @ntp.linear_op_def(bounds=([0, 0, 0], [16, 16, 128]),
                           interior=([2, 2, 2], [14, 14, 126]),
                           dtype="float32", name="wide3")
        def wide3(u):
            return u[0, 0, 0] + 0.1 * (u[-2, 0, 0] + u[2, 0, 0] + u[0, 0, 2])

        x = _x((16, 16, 128), 33)
        offs = [((0, 0, 0), 1.0), ((-2, 0, 0), 0.1), ((2, 0, 0), 0.1),
                ((0, 0, 2), 0.1)]
        want = np_oracle.linear(x, offs, ((2, 2, 2), (14, 14, 126)))
        np.testing.assert_allclose(np.asarray(wide3(x)), want, atol=1e-5)

    def test_scalar_operand(self):
        from neptune_tpu.ir import F32, Bounds, NeptuneBuilder, TempType

        b = NeptuneBuilder()
        tt = TempType("float32", Bounds.of((0, 0), (64, 128)))
        fn = b.make_opdef("scaled", "nonlinear_opdef", [tt, F32], [tt])
        b.push_block(fn.body)
        op, body = b.start_apply([fn.body.args[0]],
                                 Bounds.of((2, 0), (62, 128)),
                                 scalar_params=[fn.body.args[1]])
        b.push_block(body)
        u = body.args[2]
        b.yield_(b.mul(body.args[3],
                       b.add(b.access(u, (2, 0)), b.access(u, (-2, 0)))))
        b.pop_block()
        b.return_([b.finish_apply(op)])
        b.pop_block()
        cm = compile_ir(b.module)
        x = _x((64, 128), 34)
        want = np_oracle.linear(x, [((2, 0), 0.5), ((-2, 0), 0.5)],
                                ((2, 0), (62, 128)))
        got = np.asarray(cm.opdef("scaled")(x, np.float32(0.5)))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_two_inputs_index_select(self):
        @ntp.nonlinear_op_def(bounds=([0, 0], [20, 300]), dtype="float32",
                              name="mixed")
        def mixed(u, v):
            i = ntp.index(0)
            return ntp.where(i < 5, u[2, 0] * v[0, -2], u[0, 0] - v[-2, 1])

        x, y = _x((20, 300), 35), _x((20, 300), 36)
        rows = np.arange(20)[:, None]
        want = np_oracle.apply(
            x,
            lambda r: np.where(
                rows < 5,
                r(2, 0) * np_oracle.shift(y.astype(np.float64), (0, -2)),
                r(0, 0) - np_oracle.shift(y.astype(np.float64), (-2, 1)),
            ),
        )
        # reads off the array are unspecified by the apply contract: compare
        # the cells whose reads all stay inside
        inner = (slice(2, -2), slice(2, -2))
        got = np.asarray(mixed(x, y))
        np.testing.assert_allclose(got[inner], want[inner], atol=1e-5)

    def test_pinned_arithmetic(self, monkeypatch):
        monkeypatch.setattr(config, "pinned_arithmetic", True)
        op = _adv4(64, 128, "float32", "adv4pin")
        x = _x((64, 128), 37)
        want = np_oracle.linear(x, np_oracle.ADV4, np_oracle.interior(x.shape, 2))
        np.testing.assert_allclose(np.asarray(op(x)), want, atol=1e-5)

    def test_jvp_is_the_stencil(self):
        # adv4 is linear with copy-through, so its tangent map is itself
        _adv4(64, 128, "float64", "adv4j")
        f = ntp.get_context().compiled().opdef("adv4j")
        x, v = _x((64, 128), 38, np.float64), _x((64, 128), 39, np.float64)
        y, t = jax.jvp(f, (jnp.asarray(x),), (jnp.asarray(v),))
        box = np_oracle.interior(x.shape, 2)
        np.testing.assert_allclose(
            np.asarray(y), np_oracle.linear(x, np_oracle.ADV4, box), atol=1e-13)
        np.testing.assert_allclose(
            np.asarray(t), np_oracle.linear(v, np_oracle.ADV4, box), atol=1e-13)

    def test_grad_matches_finite_difference(self):
        _adv4(32, 64, "float64", "adv4g")
        f = ntp.get_context().compiled().opdef("adv4g")
        x, v = _x((32, 64), 40, np.float64), _x((32, 64), 41, np.float64)

        def loss(z):
            return jnp.sum(f(z) ** 2)

        g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
        eps = 1e-6
        fd = (float(loss(jnp.asarray(x + eps * v)))
              - float(loss(jnp.asarray(x - eps * v)))) / (2 * eps)
        np.testing.assert_allclose(np.sum(g * v), fd, rtol=1e-7)


class TestBackendChoice:
    @pytest.mark.parametrize("backend", ["pallas", "native", "triton"])
    def test_unknown_backend_raises(self, backend):
        _adv4(16, 16, "float64", "adv4b")
        module = ntp.get_context().compiled().module
        with pytest.raises(ValueError, match="unknown backend"):
            CompiledModule(module, backend)
        config.backend = backend  # the NEPTUNE_TPU_BACKEND default
        with pytest.raises(ValueError, match="unknown backend"):
            compile_ir(module)

    def test_auto_is_jnp(self):
        op = _adv4(32, 32, "float64", "adv4c")
        module = ntp.get_context().compiled().module
        x = _x((32, 32), 11, np.float64)
        a = np.asarray(CompiledModule(module, "auto").opdef("adv4c")(x))
        b = np.asarray(CompiledModule(module, "jnp").opdef("adv4c")(x))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(op(x)), a)


class TestShardedApplyOracle:
    """shardmap_opdef's fused-strip route against the whole-grid NumPy
    stencil: strip exchange, band fixups and traced global coordinates
    compose to the same answer on 1- and 2-axis meshes."""

    @pytest.mark.parametrize("axes", [(2, 1), (2, 2)])
    def test_rank2_wide_fused_strips(self, axes):
        from neptune_tpu.parallel import GridMesh, shardmap_opdef

        n, m = 128, 256
        _adv4(n, m, "float32", "adv4sh")
        cm = ntp.get_context().compiled()
        gm = GridMesh(axes, ("x", "y"))
        f = jax.jit(shardmap_opdef(cm, "adv4sh", gm))
        x = _x((n, m), 21)
        out = np.asarray(f(gm.shard(x)))
        want = np_oracle.linear(x, np_oracle.ADV4, np_oracle.interior(x.shape, 2))
        np.testing.assert_allclose(out, want, atol=1e-5)

    def test_rank2_bf16(self):
        from neptune_tpu.parallel import GridMesh, shardmap_opdef

        n, m = 128, 256

        @ntp.nonlinear_op_def(
            bounds=([0, 0], [n, m]), interior=([2, 2], [n - 2, m - 2]),
            dtype="bfloat16", name="adv4shb",
        )
        def adv4shb(u):
            return u[0, 0] - 0.1 * (u[2, 0] - u[-2, 0] + u[0, 2] - u[0, -2])

        cm = ntp.get_context().compiled()
        gm = GridMesh((2, 1), ("x", "y"))
        f = jax.jit(shardmap_opdef(cm, "adv4shb", gm))
        xb = jnp.asarray(_x((n, m), 23), jnp.bfloat16)
        out = np.asarray(f(gm.shard(xb)), np.float32)
        offs = [((0, 0), 1.0), ((2, 0), -0.1), ((-2, 0), 0.1), ((0, 2), -0.1),
                ((0, -2), 0.1)]
        want = np_oracle.linear(
            np.asarray(xb, np.float32), offs, np_oracle.interior((n, m), 2)
        )
        np.testing.assert_allclose(out, want, atol=5e-2)

    def test_rank3_traced_start(self):
        from neptune_tpu.parallel import GridMesh, shardmap_opdef

        m, w = 32, 256
        _heat3(m, w, "heat3sh")
        cm = ntp.get_context().compiled()
        gm = GridMesh((2, 2), ("x", "y"))
        f = jax.jit(shardmap_opdef(cm, "heat3sh", gm))
        x = _x((m, m, w), 29)
        out = np.asarray(f(gm.shard(x)))
        want = np_oracle.linear(x, HEAT3, np_oracle.interior(x.shape, 1))
        np.testing.assert_allclose(out, want, atol=1e-5)
