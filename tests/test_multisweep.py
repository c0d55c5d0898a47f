"""Repeated application (`cm.sweeps`, `ntp.sweeps`, `shardmap_sweeps`) against
K NumPy stencil steps (`np_oracle.sweeps`), across halo widths, domain
shapes (small, wide rows, non-multiple-of-8 extents, rank 3), scalar
parameters, torus domains, deep K, and the rejection paths.
"""

import numpy as np
import pytest

import np_oracle
from neptune_tpu.ir import F32, F64, Bounds, NeptuneBuilder, TempType
from neptune_tpu.passes import compile_ir


def jacobi_module(n0, n1, offsets_coefs, *, dtype="float32", periodic=False,
                  n_scalars=0, interior=None):
    """opdef y = sum_c c * x[off] over the halo-shrunk interior."""
    b = NeptuneBuilder()
    bounds = Bounds.of((0, 0), (n0, n1))
    tt = TempType(dtype, bounds)
    stypes = [F32] * n_scalars
    fn = b.make_opdef("op", "nonlinear_opdef", [tt] + stypes, [tt])
    b.push_block(fn.body)
    if interior is None:
        h = [max(abs(o[d]) for o, _ in offsets_coefs) for d in (0, 1)]
        interior = bounds if periodic else Bounds.of(
            (h[0], h[1]), (n0 - h[0], n1 - h[1])
        )
    op, body = b.start_apply(
        [fn.body.args[0]],
        interior,
        scalar_params=list(fn.body.args[1:]),
        periodic=periodic,
    )
    b.push_block(body)
    cdtype = F64 if dtype == "float64" else F32
    acc = None
    for off, c in offsets_coefs:
        t = b.mul(b.access(body.args[2], off), b.constant(c, cdtype))
        acc = t if acc is None else b.add(acc, t)
    # scale by the trailing scalar params so they reach the DAG
    for sa in body.args[3:]:
        acc = b.mul(acc, sa)
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module


FIVE_POINT = [((0, 0), 0.6), ((-1, 0), 0.1), ((1, 0), 0.1),
              ((0, -1), 0.1), ((0, 1), 0.1)]
WIDE = [((0, 0), 0.4), ((-2, 0), 0.15), ((2, 0), 0.15),
        ((0, -2), 0.15), ((0, 2), 0.15)]


def _box(shape, offsets_coefs, periodic):
    if periodic:
        return None
    h = [max(abs(o[d]) for o, _ in offsets_coefs) for d in range(len(shape))]
    return np_oracle.interior(shape, h)


def run_oracle(module, shape, k, offsets_coefs, *, periodic=False,
               n_scalars=0, dtype=np.float32, atol=1e-5, box=None):
    """cm.sweeps(op, k) == k NumPy steps of the same linear stencil."""
    cm = compile_ir(module)
    x = np.random.default_rng(42).standard_normal(shape).astype(dtype)
    scalars = [np.float32(0.9)] * n_scalars
    coefs = [(o, c * 0.9 ** n_scalars) for o, c in offsets_coefs]
    y = np.asarray(cm.sweeps("op", k)(x, *scalars))
    if box is None:
        box = _box(shape, offsets_coefs, periodic)
    want = np_oracle.sweeps(x, coefs, k, box, periodic)
    np.testing.assert_allclose(y, want, atol=atol)


class TestSweeps2D:
    @pytest.mark.parametrize("k", [2, 4, 8])
    def test_five_point(self, k):
        run_oracle(jacobi_module(128, 256, FIVE_POINT), (128, 256), k,
                   FIVE_POINT)

    def test_wide_halo(self):
        run_oracle(jacobi_module(128, 256, WIDE), (128, 256), 4, WIDE)

    def test_small_grid(self):
        run_oracle(jacobi_module(96, 128, FIVE_POINT), (96, 128), 3,
                   FIVE_POINT)

    def test_asymmetric_offsets(self):
        offs = [((0, 0), 0.5), ((-2, 1), 0.2), ((1, -1), 0.3)]
        run_oracle(jacobi_module(128, 128, offs), (128, 128), 4, offs)

    def test_scalar_params(self):
        run_oracle(jacobi_module(128, 128, FIVE_POINT, n_scalars=1),
                   (128, 128), 3, FIVE_POINT, n_scalars=1)

    def test_periodic(self):
        run_oracle(jacobi_module(64, 128, FIVE_POINT, periodic=True),
                   (64, 128), 4, FIVE_POINT, periodic=True)

    def test_f64(self):
        run_oracle(jacobi_module(64, 128, FIVE_POINT, dtype="float64"),
                   (64, 128), 4, FIVE_POINT, dtype=np.float64, atol=1e-12)

    def test_deep_wide(self):
        run_oracle(jacobi_module(256, 256, WIDE), (256, 256), 16, WIDE)

    def test_deep_five_point(self):
        run_oracle(jacobi_module(256, 256, FIVE_POINT), (256, 256), 32,
                   FIVE_POINT)

    def test_wide_rows(self):
        run_oracle(jacobi_module(256, 2048, WIDE), (256, 2048), 16, WIDE)

    @pytest.mark.parametrize("k", [11, 16])
    def test_odd_depths(self, k):
        run_oracle(jacobi_module(128, 256, FIVE_POINT), (128, 256), k,
                   FIVE_POINT)

    def test_big_grid(self):
        run_oracle(jacobi_module(1152, 1024, FIVE_POINT), (1152, 1024), 4,
                   FIVE_POINT)

    def test_periodic_k6(self):
        run_oracle(jacobi_module(64, 128, FIVE_POINT, periodic=True),
                   (64, 128), 6, FIVE_POINT, periodic=True)

    def test_periodic_big_grid(self):
        run_oracle(jacobi_module(1152, 1024, FIVE_POINT, periodic=True),
                   (1152, 1024), 4, FIVE_POINT, periodic=True)

    def test_deep_k40(self):
        run_oracle(jacobi_module(128, 128, FIVE_POINT), (128, 128), 40,
                   FIVE_POINT, atol=3e-5)

    def test_non_8_multiple_extent(self):
        run_oracle(jacobi_module(500, 256, FIVE_POINT), (500, 256), 4,
                   FIVE_POINT)

    def test_deep_reach_wide_rows(self):
        # reach 9 in dim 0 over 16384-wide rows
        offs = [((0, 0), 0.4), ((-9, 0), 0.3), ((9, 0), 0.3)]
        run_oracle(jacobi_module(64, 16384, offs), (64, 16384), 2, offs)


def test_dsl_sweeps_surface():
    # the frontend-level entry point: ntp.sweeps(decorated_op, k)
    import neptune_tpu as ntp

    ntp.reset_context()

    @ntp.linear_op_def(
        bounds=([0, 0], [128, 256]), interior=([1, 1], [127, 255]),
        dtype="float32",
    )
    def jac(u):
        return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

    x = np.random.default_rng(0).standard_normal((128, 256)).astype(np.float32)
    offs = [((-1, 0), .25), ((1, 0), .25), ((0, -1), .25), ((0, 1), .25)]
    want = np_oracle.sweeps(x, offs, 4, np_oracle.interior(x.shape, 1))
    y = np.asarray(ntp.sweeps(jac, 4)(x))
    np.testing.assert_allclose(y, want, atol=1e-5)


def test_sweeps_rejects_non_unary():
    b = NeptuneBuilder()
    tt = TempType("float32", Bounds.of((0, 0), (16, 16)))
    fn = b.make_opdef("binop", "nonlinear_opdef", [tt, tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply(list(fn.body.args), Bounds.of((0, 0), (16, 16)))
    b.push_block(body)
    b.yield_(b.add(b.access(body.args[2], (0, 0)), b.access(body.args[3], (0, 0))))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    cm = compile_ir(b.module)
    with pytest.raises(ValueError, match="unary"):
        cm.sweeps("binop", 4)


def test_dsl_sweeps_rejects_traced_mode():
    import neptune_tpu as ntp

    ntp.reset_context()

    @ntp.linear_op_def(
        bounds=([0, 0], [64, 128]), interior=([1, 1], [63, 127]),
        dtype="float32", name="tr",
    )
    def op(u):
        return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

    ctx = ntp.get_context()
    fn = ctx.builder.make_function("dummy_trace", "func", [], [])
    ctx.current_function = fn  # simulate an active method trace
    try:
        with pytest.raises(RuntimeError, match="outside the traced"):
            ntp.sweeps(op, 4)
    finally:
        ctx.current_function = None
        ctx.module.functions.pop("dummy_trace", None)


def jacobi_module_3d(n0, n1, n2, offsets_coefs, *, periodic=False):
    """Rank-3 variant of jacobi_module (7-pt heat style)."""
    b = NeptuneBuilder()
    bounds = Bounds.of((0, 0, 0), (n0, n1, n2))
    tt = TempType("float32", bounds)
    fn = b.make_opdef("op", "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    h = [max(abs(o[d]) for o, _ in offsets_coefs) for d in (0, 1, 2)]
    interior = bounds if periodic else Bounds.of(
        (h[0], h[1], h[2]), (n0 - h[0], n1 - h[1], n2 - h[2])
    )
    op, body = b.start_apply([fn.body.args[0]], interior, periodic=periodic)
    b.push_block(body)
    acc = None
    for off, c in offsets_coefs:
        t = b.mul(b.access(body.args[3], off), b.constant(c, F32))
        acc = t if acc is None else b.add(acc, t)
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module


SEVEN_POINT = [((0, 0, 0), 0.4), ((-1, 0, 0), 0.1), ((1, 0, 0), 0.1),
               ((0, -1, 0), 0.1), ((0, 1, 0), 0.1),
               ((0, 0, -1), 0.1), ((0, 0, 1), 0.1)]


class TestSweeps3D:
    @pytest.mark.parametrize("k", [2, 4])
    def test_seven_point(self, k):
        m = jacobi_module_3d(96, 64, 256, SEVEN_POINT)
        run_oracle(m, (96, 64, 256), k, SEVEN_POINT)

    def test_seven_point_small(self):
        m = jacobi_module_3d(32, 32, 128, SEVEN_POINT)
        run_oracle(m, (32, 32, 128), 4, SEVEN_POINT)

    def test_periodic_3d(self):
        m = jacobi_module_3d(32, 32, 128, SEVEN_POINT, periodic=True)
        run_oracle(m, (32, 32, 128), 3, SEVEN_POINT, periodic=True)

    def test_wide_halo_3d(self):
        offs = [((0, 0, 0), 0.5), ((-2, 0, 0), 0.1), ((2, 0, 0), 0.1),
                ((0, -1, 0), 0.1), ((0, 1, 0), 0.1),
                ((0, 0, -2), 0.1), ((0, 0, 2), 0.1)]
        m = jacobi_module_3d(96, 64, 256, offs)
        run_oracle(m, (96, 64, 256), 3, offs)


class TestWideRowShapes:
    """Wide rows at reach 2 with K = 8: the shapes that once took a
    two-level (slab x panel) window, whole-grid and sharded."""

    def test_wide(self):
        run_oracle(jacobi_module(256, 1024, WIDE), (256, 1024), 8, WIDE)

    def test_wide_with_scalars(self):
        run_oracle(jacobi_module(256, 1024, WIDE, n_scalars=1),
                   (256, 1024), 8, WIDE, n_scalars=1)

    def test_dim0_only_stencil(self):
        offs = [((0, 0), 0.6), ((-2, 0), 0.2), ((2, 0), 0.2)]
        run_oracle(jacobi_module(256, 1024, offs), (256, 1024), 8, offs)

    def test_asymmetric_offsets(self):
        offs = [((0, 0), 0.5), ((-2, 1), 0.2), ((1, -2), 0.3)]
        run_oracle(jacobi_module(256, 1024, offs), (256, 1024), 8, offs)

    def test_sharded_wide_rows(self):
        # shardmap_sweeps on 256 x 1024 local blocks: K*reach-deep strips
        # and trapezoid bands vs K NumPy steps over the whole grid
        import jax
        import jax.numpy as jnp

        import neptune_tpu as ntp
        from neptune_tpu.parallel import GridMesh, shardmap_sweeps

        ntp.reset_context()
        n0, n1, k = 512, 1024, 8

        @ntp.nonlinear_op_def(
            bounds=([0, 0], [n0, n1]), interior=([2, 2], [n0 - 2, n1 - 2]),
            dtype="float32",
        )
        def adv4(u):
            dudx = (-u[2, 0] + 8.0 * u[1, 0] - 8.0 * u[-1, 0] + u[-2, 0]) / 12.0
            dudy = (-u[0, 2] + 8.0 * u[0, 1] - 8.0 * u[0, -1] + u[0, -2]) / 12.0
            return u[0, 0] - 0.1 * (0.7 * dudx + 0.3 * dudy)

        cm = ntp.get_context().compiled()
        gm = GridMesh((2,), ("x",), devices=jax.devices()[:2])
        x = np.random.default_rng(9).standard_normal((n0, n1)).astype(np.float32)
        y = shardmap_sweeps(cm, "adv4", gm, k)(gm.shard(jnp.asarray(x)))
        want = np_oracle.sweeps(
            x, np_oracle.ADV4, k, np_oracle.interior(x.shape, 2)
        )
        np.testing.assert_allclose(np.asarray(y), want, atol=1e-5)
        ntp.reset_context()


class TestPeriodicSweeps:
    """Torus sweeps: K applications must equal K NumPy roll steps, with
    the wrap across the array edge; and a periodic operator with a
    copy-through interior ring."""

    def test_torus_dsl(self):
        import neptune_tpu as ntp

        ntp.reset_context()
        n = 256

        @ntp.linear_op_def(
            bounds=([0, 0], [n, 128]), dtype="float32", periodic=True,
            name="torus_sw",
        )
        def torus_sw(u):
            return u[0, 0] + 0.1 * (
                u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0]
            )

        x = np.random.default_rng(0).standard_normal((n, 128)).astype(
            np.float32
        )
        got = np.asarray(ntp.sweeps(torus_sw, 4)(x))
        want = x.astype(np.float64)
        for _ in range(4):
            lap = (np.roll(want, 1, 0) + np.roll(want, -1, 0)
                   + np.roll(want, 1, 1) + np.roll(want, -1, 1)
                   - 4.0 * want)
            want = want + 0.1 * lap
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_periodic_interior_bounds(self):
        n = 256
        offs = [((-1, 0), .25), ((1, 0), .25), ((0, -1), .25), ((0, 1), .25)]
        m = jacobi_module(n, 128, offs, periodic=True,
                          interior=Bounds.of((1, 1), (n - 1, 127)))
        run_oracle(m, (n, 128), 4, offs, periodic=True,
                   box=np_oracle.interior((n, 128), 1))
