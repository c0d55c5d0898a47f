"""Multi-device tests on the 8-device virtual CPU mesh (conftest forces
--xla_force_host_platform_device_count=8) — multi-node testing without a
cluster (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neptune_tpu as ntp
import np_oracle
from neptune_tpu.parallel import (
    GridMesh,
    halo_pad_local,
    sharded_function,
    sharded_opdef,
    sharded_stencil,
)
from neptune_tpu.passes import compile_ir

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(autouse=True)
def fresh():
    ntp.reset_context()
    yield
    ntp.reset_context()


def lap2d_np(x):
    y = x.copy()
    y[1:-1, 1:-1] = (
        4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1] - x[1:-1, :-2] - x[1:-1, 2:]
    )
    return y


def make_lap2d(n=64):
    @ntp.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]))
    def lap2d(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    return lap2d


class TestGridMesh:
    def test_mesh_2d(self):
        gm = GridMesh((4, 2), ("x", "y"))
        assert gm.n_devices == 8
        s = gm.sharding(2)
        assert s.spec == jax.sharding.PartitionSpec("x", "y")

    def test_divisibility_check(self):
        gm = GridMesh((4, 2), ("x", "y"))
        with pytest.raises(ValueError, match="divisible"):
            gm.check_divisible((63, 64))

    def test_abstract_mesh_plans_beyond_host_devices(self):
        # topology-only mesh: plan a 32-device layout on an 8-device host;
        # the report must be byte-identical to a concrete mesh of the same
        # shape (where one fits)
        import programs

        from neptune_tpu.parallel import plan_opdef, plan_report

        m = programs.build_heat3d_explicit()
        cm = compile_ir(m)
        big = GridMesh((16, 2), ("x", "y"), abstract=True)
        assert big.n_devices == 32
        rp = plan_opdef(cm, "heat3d_rhs", big)
        # 8x8x8 grid over 16-way dim 0: 8 % 16 != 0 -> fused plan infeasible,
        # composite check also fails divisibility -> extended-block
        assert rp.kind == "extended-block"
        small_abs = GridMesh((2, 2), ("x", "y"), abstract=True)
        small = GridMesh((2, 2), ("x", "y"))
        assert plan_report(cm, "heat3d_rhs", small_abs) == plan_report(
            cm, "heat3d_rhs", small
        )


class TestGSPMD:
    def test_sharded_matvec_matches_local(self):
        lap = make_lap2d(64)
        gm = GridMesh((4, 2), ("x", "y"))
        ctx = ntp.get_context()
        cm = ctx.compiled()
        f = sharded_opdef(cm, "lap2d", gm)
        x = np.random.default_rng(0).standard_normal((64, 64))
        xs = gm.shard(jnp.asarray(x))
        out = np.asarray(f(xs))
        np.testing.assert_allclose(out, lap2d_np(x), atol=1e-13)

    def test_sharded_cg_bit_stable(self):
        # distributed matrix-free CG: same answer (and bitwise-identical
        # between runs) on a sharded mesh — BASELINE.md's bit-stability bar
        from neptune_tpu.solvers import cg

        lap = make_lap2d(64)
        gm = GridMesh((4, 2), ("x", "y"))
        cm = ntp.get_context().compiled()
        matvec = cm.opdef("lap2d")
        b = np.random.default_rng(1).standard_normal((64, 64))

        @jax.jit
        def solve(b):
            x, info = cg(matvec, b, tol=1e-12, maxiter=2000)
            return x, info.iters

        bs = gm.shard(jnp.asarray(b))
        x1, it1 = solve(bs)
        x2, it2 = solve(bs)
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
        assert int(it1) == int(it2)
        # also matches the single-device solve
        x_local, _ = solve(jnp.asarray(b))
        res = lap2d_np(np.asarray(x1))
        np.testing.assert_allclose(res, b, atol=1e-8)
        np.testing.assert_allclose(np.asarray(x_local), np.asarray(x1), atol=1e-9)

    def test_sharded_full_function(self):
        import programs

        m = programs.build_allen_cahn_implicit_linear(n=16)
        cm = compile_ir(m)
        gm = GridMesh((8,), ("x",))
        f = sharded_function(cm, "entry", gm)
        uin = np.sin(np.linspace(0, np.pi, 16))
        out = np.asarray(f(np.zeros(16), uin))
        oracle = programs.allen_cahn_implicit_linear_oracle(uin)
        np.testing.assert_allclose(out, oracle, atol=1e-9)


class TestShardMapHalo:
    def test_halo_pad_matches_global_pad(self):
        gm = GridMesh((4, 2), ("x", "y"))
        x = np.arange(64 * 64, dtype=np.float64).reshape(64, 64)
        halo = ((1, 1), (2, 0))

        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        def local(u_loc):
            ext = halo_pad_local(u_loc, halo, ["x", "y"])
            # return the recentered interior == original local block
            return ext[1:-1, 2:]

        f = shard_map(
            local,
            mesh=gm.mesh,
            in_specs=(P("x", "y"),),
            out_specs=P("x", "y"),
            check_rep=False,
        )
        out = np.asarray(f(gm.shard(jnp.asarray(x))))
        np.testing.assert_array_equal(out, x)

    def test_sharded_stencil_sweep(self):
        gm = GridMesh((4, 2), ("x", "y"))
        n = 64
        x = np.random.default_rng(3).standard_normal((n, n))

        def local_sweep(ext, info):
            # 5-pt laplacian on the extended block; interior mask via global
            # coordinates
            c = ext[1:-1, 1:-1]
            lap = 4 * c - ext[:-2, 1:-1] - ext[2:, 1:-1] - ext[1:-1, :-2] - ext[1:-1, 2:]
            si, sj = info["start"]
            gi = si + jax.lax.broadcasted_iota(jnp.int32, c.shape, 0)
            gj = sj + jax.lax.broadcasted_iota(jnp.int32, c.shape, 1)
            mask = (gi >= 1) & (gi < n - 1) & (gj >= 1) & (gj < n - 1)
            return jnp.where(mask, lap, c)

        f = jax.jit(sharded_stencil(local_sweep, gm, ((1, 1), (1, 1)), 2))
        out = np.asarray(f(gm.shard(jnp.asarray(x))))
        np.testing.assert_allclose(out, lap2d_np(x), atol=1e-13)


    def test_sharded_stencil_periodic_torus(self):
        # review: sharded_stencil had no periodic flag, so torus operators
        # got zero-filled ghosts at the global domain edge
        gm = GridMesh((4, 2), ("x", "y"))
        n = 64
        x = np.random.default_rng(4).standard_normal((n, n))

        def local_sweep(ext, info):
            c = ext[1:-1, 1:-1]
            return (
                4 * c - ext[:-2, 1:-1] - ext[2:, 1:-1]
                - ext[1:-1, :-2] - ext[1:-1, 2:]
            )

        f = jax.jit(
            sharded_stencil(
                local_sweep, gm, ((1, 1), (1, 1)), 2, periodic=True
            )
        )
        out = np.asarray(f(gm.shard(jnp.asarray(x))))
        expect = (
            4 * x
            - np.roll(x, 1, 0) - np.roll(x, -1, 0)
            - np.roll(x, 1, 1) - np.roll(x, -1, 1)
        )
        np.testing.assert_allclose(out, expect, atol=1e-13)

    def test_sharded_opdef_reuses_opdef_cache(self):
        # review: every sharded_opdef call used to rebuild a module view,
        # discarding the opdef/structure caches (re-jit per solve)
        make_lap2d()
        cmp = ntp.get_context().compiled()
        gm = GridMesh((8, 1), ("x", "y"))
        f1 = sharded_opdef(cmp, "lap2d", gm)
        f2 = sharded_opdef(cmp, "lap2d", gm)
        assert f1.__wrapped__ is f2.__wrapped__ is cmp.opdef("lap2d")


class TestShardMapOpdef:
    def test_matches_local_execution(self):
        # explicit-communication sharded matvec == single-device result
        from neptune_tpu.parallel import shardmap_opdef

        make_lap2d(64)
        gm = GridMesh((4, 2), ("x", "y"))
        cm = ntp.get_context().compiled()
        f = jax.jit(shardmap_opdef(cm, "lap2d", gm))
        x = np.random.default_rng(7).standard_normal((64, 64))
        out = np.asarray(f(gm.shard(jnp.asarray(x))))
        np.testing.assert_allclose(out, lap2d_np(x), atol=1e-13)

    def test_composite_operator_one_exchange(self):
        # ac_A-style wrapper: exchange depth = composed reach, result matches
        from neptune_tpu.parallel import shardmap_opdef
        from neptune_tpu.ir import Bounds, TempType, F64

        n = 64
        make_lap2d(n)
        ctx = ntp.get_context()
        b = ctx.builder
        tt = TempType("float64", Bounds.of([0, 0], [n, n]))
        fn = b.make_opdef("wrapped", "linear_opdef", [tt], [tt])
        b.push_block(fn.body)
        lapx = b.apply_linear("lap2d", [fn.body.args[0]])
        lap2x = b.apply_linear("lap2d", [lapx])  # composed reach = 2
        op, body = b.start_apply([fn.body.args[0], lap2x], tt.bounds)
        b.push_block(body)
        x0 = b.access(body.args[2], [0, 0])
        l0 = b.access(body.args[3], [0, 0])
        b.yield_(b.add(x0, b.mul(b.constant(0.01, F64), l0)))
        b.pop_block()
        b.return_([b.finish_apply(op)])
        b.pop_block()
        ctx.bump()

        cm = ctx.compiled()
        assert cm.module.lookup("wrapped").attrs["halo"] == ((2, 2), (2, 2))
        gm = GridMesh((4, 2), ("x", "y"))
        f = jax.jit(shardmap_opdef(cm, "wrapped", gm))
        x = np.random.default_rng(8).standard_normal((n, n))
        out = np.asarray(f(gm.shard(jnp.asarray(x))))
        ref = np.asarray(cm.opdef("wrapped")(x))
        np.testing.assert_allclose(out, ref, atol=1e-12)

    def test_sharded_cg_through_shardmap_matvec(self):
        from neptune_tpu.parallel import shardmap_opdef
        from neptune_tpu.solvers import cg

        make_lap2d(64)
        gm = GridMesh((4, 2), ("x", "y"))
        cm = ntp.get_context().compiled()
        mv = shardmap_opdef(cm, "lap2d", gm)
        b = np.random.default_rng(9).standard_normal((64, 64))

        @jax.jit
        def solve(b):
            x, info = cg(mv, b, tol=1e-12, maxiter=3000)
            return x

        x = np.asarray(solve(gm.shard(jnp.asarray(b))))
        np.testing.assert_allclose(lap2d_np(x), b, atol=1e-8)

    def test_sharded_chebyshev_reduction_free(self):
        """Chebyshev through the shard_map matvec: the solve loop contains
        no inner products, so the only per-iteration collectives are the
        halo ppermutes. With explicit bounds, the WHOLE solve is psum-free
        until the final residual norm; the answer must match the dense
        solution, be bitwise run-to-run reproducible on a fixed mesh, and
        agree across mesh shapes to near-ULP. (Cross-shape *bitwise*
        identity is not promised: XLA's FMA contraction decisions depend on
        the local block shapes, so the same elementwise dag can round
        differently per mesh — observed ~1e-14 after 4000 iterations.)"""
        from neptune_tpu.parallel import shardmap_opdef
        from neptune_tpu.solvers import chebyshev

        b = np.random.default_rng(12).standard_normal((64, 64))
        # 2-D Dirichlet Poisson spectrum bounds: 4..8 with margins
        lmin = 2.0 * (2.0 - 2.0 * np.cos(np.pi / 65))
        sols = {}
        for axes in ((8, 1), (4, 2), (2, 4)):
            ntp.reset_context()
            make_lap2d(64)
            gm = GridMesh(axes, ("x", "y"))
            cm = ntp.get_context().compiled()
            mv = shardmap_opdef(cm, "lap2d", gm)

            @jax.jit
            def solve(bb):
                x, info = chebyshev(
                    mv, bb, lam_min=lmin, lam_max=8.0, maxiter=4000
                )
                return x

            bs = gm.shard(jnp.asarray(b))
            sols[axes] = np.asarray(solve(bs))
            np.testing.assert_allclose(lap2d_np(sols[axes]), b, atol=1e-7)
            # determinism on a fixed topology is exact
            np.testing.assert_array_equal(sols[axes], np.asarray(solve(bs)))
        np.testing.assert_allclose(sols[(8, 1)], sols[(4, 2)], atol=2e-13)
        np.testing.assert_allclose(sols[(4, 2)], sols[(2, 4)], atol=2e-13)

    def test_shardmap_opdef_f32_2d_mesh(self):
        # f32 5-pt Laplacian on a 2-axis mesh vs the NumPy stencil
        from neptune_tpu.parallel import shardmap_opdef

        ntp.reset_context()

        @ntp.linear_op_def(
            bounds=([0, 0], [128, 256]), interior=([1, 1], [127, 255]),
            dtype="float32", name="lap_p",
        )
        def lap_p(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        gm = GridMesh((4, 2), ("x", "y"))
        cm = ntp.get_context().compiled()
        f = jax.jit(shardmap_opdef(cm, "lap_p", gm))
        x = np.random.default_rng(11).standard_normal((128, 256)).astype(
            np.float32
        )
        out = np.asarray(f(gm.shard(jnp.asarray(x))))
        ref = np_oracle.linear(
            x, np_oracle.LAP5, np_oracle.interior(x.shape, 1)
        )
        np.testing.assert_allclose(out, ref, atol=1e-5)


class TestShardmapSweeps:
    """Communication-avoiding K-sweeps-per-exchange (`shardmap_sweeps`)."""

    def _oracle(self, cm, name, x, k):
        f = cm.function(name)

        @jax.jit
        def run(v):
            return jax.lax.fori_loop(0, k, lambda i, u: f(u), v)

        return np.asarray(run(jnp.asarray(x)))

    @pytest.mark.parametrize("axes", [(8, 1), (4, 2), (2, 4)])
    @pytest.mark.parametrize("k", [1, 2, 4])
    def test_matches_k_applications_2d(self, axes, k):
        # k=4 on (8,1) is the edge of the one-shard reach gate: 64/8 = 8
        # local rows == k*(lo+hi)
        from neptune_tpu.parallel import shardmap_sweeps

        make_lap2d(64)
        cm = ntp.get_context().compiled()
        gm = GridMesh(axes, ("x", "y"))
        fk = shardmap_sweeps(cm, "lap2d", gm, k)
        x = np.random.default_rng(3).standard_normal((64, 64))
        got = np.asarray(jax.jit(fk)(gm.shard(jnp.asarray(x))))
        want = self._oracle(cm, "lap2d", x, k)
        np.testing.assert_allclose(got, want, atol=1e-11)

    def test_wide_stencil_asymmetric_mesh(self):
        # 4th-order reach (h=2): K*h strips, trapezoid bands wider than h
        from neptune_tpu.parallel import shardmap_sweeps

        n = 64

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([2, 2], [n - 2, n - 2])
        )
        def adv4(u):
            return (
                u[2, 0] - 2.0 * u[1, 0] + u[-1, 0] - u[-2, 0]
                + u[0, 2] - 2.0 * u[0, 1] + u[0, -1] - u[0, -2]
                + 4.0 * u[0, 0]
            )

        cm = ntp.get_context().compiled()
        gm = GridMesh((2, 4), ("x", "y"))
        for k in (1, 3):
            fk = shardmap_sweeps(cm, "adv4", gm, k)
            x = np.random.default_rng(5).standard_normal((n, n))
            got = np.asarray(jax.jit(fk)(gm.shard(jnp.asarray(x))))
            want = self._oracle(cm, "adv4", x, k)
            np.testing.assert_allclose(got, want, atol=1e-11)

    def test_rank3(self):
        from neptune_tpu.parallel import shardmap_sweeps

        m = 24

        @ntp.linear_op_def(
            bounds=([0, 0, 0], [m, m, m]),
            interior=([1, 1, 1], [m - 1, m - 1, m - 1]),
        )
        def lap3(u):
            return (
                6.0 * u[0, 0, 0]
                - u[1, 0, 0] - u[-1, 0, 0]
                - u[0, 1, 0] - u[0, -1, 0]
                - u[0, 0, 1] - u[0, 0, -1]
            )

        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        fk = shardmap_sweeps(cm, "lap3", gm, 3)
        x = np.random.default_rng(7).standard_normal((m, m, m))
        got = np.asarray(jax.jit(fk)(gm.shard(jnp.asarray(x))))
        want = self._oracle(cm, "lap3", x, 3)
        np.testing.assert_allclose(got, want, atol=1e-11)

    @pytest.mark.parametrize("k", [1, 2])
    def test_f32_core_sweep(self, k):
        # f32 K sweeps per exchange vs K NumPy 5-pt sweeps
        from neptune_tpu.parallel import shardmap_sweeps

        n = 128

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]),
            interior=([1, 1], [n - 1, n - 1]),
            dtype="float32",
        )
        def lap2d(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        cm = ntp.get_context().compiled()
        gm = GridMesh((2,), ("x",))
        fk = shardmap_sweeps(cm, "lap2d", gm, k)
        x = np.random.default_rng(9).standard_normal((n, n)).astype(np.float32)
        got = np.asarray(jax.jit(fk)(gm.shard(jnp.asarray(x))))
        want = np_oracle.sweeps(
            x, np_oracle.LAP5, k, np_oracle.interior(x.shape, 1)
        )
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    def test_rejects_too_deep_and_composite(self):
        from neptune_tpu.parallel import shardmap_sweeps

        make_lap2d(16)
        cm = ntp.get_context().compiled()
        gm = GridMesh((8, 1), ("x", "y"))
        # 16/8 = 2 local rows; k=3 strips would span >1 shard
        with pytest.raises(ValueError, match="not eligible"):
            shardmap_sweeps(cm, "lap2d", gm, 3)


class TestShardedMultigrid:
    """Geometric multigrid on mesh-sharded fields: the V-cycle's restrict
    (block-mean reshape) and prolong (multilinear resize) partition under
    GSPMD, the smoothers and matvecs shard like any elementwise/stencil
    code, so the whole hierarchy runs distributed without MG-specific
    communication code."""

    def test_sharded_vcycle_and_mgcg(self):
        import sys

        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from test_multigrid import poisson_ops

        from neptune_tpu.solvers import cg, mg_preconditioner, multigrid_solve

        ops = poisson_ops([128, 64, 32, 16])
        gm = GridMesh((4, 2), ("x", "y"))
        rng = np.random.default_rng(0)
        b = np.zeros((128, 128))
        # interior-supported rhs: the copy-through system is nonsymmetric
        # at the boundary ring (same convention as test_multigrid)
        b[1:-1, 1:-1] = rng.standard_normal((126, 126))
        bs = gm.shard(jnp.asarray(b))

        x, info = multigrid_solve(ops, bs, tol=1e-9, maxiter=60)
        assert bool(info.converged)
        r = b - np.asarray(ops[0].matvec(jnp.asarray(np.asarray(x))))
        assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b) * 1.01

        M = mg_preconditioner(ops, bs, smoother="cheb")

        @jax.jit
        def solve(bb):
            return cg(ops[0].matvec, bb, M=M, tol=1e-8, maxiter=200)

        x2, info2 = solve(bs)
        assert bool(info2.converged)
        assert int(info2.iters) < 40  # multigrid-rate, not CG-rate

        # sharded == unsharded to fp roundoff
        Mu = mg_preconditioner(ops, jnp.asarray(b), smoother="cheb")

        @jax.jit
        def solve_u(bb):
            return cg(ops[0].matvec, bb, M=Mu, tol=1e-8, maxiter=200)

        xu, _ = solve_u(jnp.asarray(b))
        np.testing.assert_allclose(
            np.asarray(x2), np.asarray(xu), atol=1e-14
        )


class TestShardedPeriodic:
    """Torus (periodic) operators on device meshes: the ring ppermute wraps
    at the mesh boundary, which IS the torus exchange — global-edge ghosts
    keep the wrapped data instead of being zeroed; unsharded dims wrap
    locally (their local extent is global)."""

    def _torus_op(self, n):
        @ntp.linear_op_def(bounds=([0, 0], [n, n]), periodic=True)
        def lap_torus(u):
            return u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4.0 * u[0, 0]

        return lap_torus

    def _oracle(self, x):
        return (
            np.roll(x, -1, 0) + np.roll(x, 1, 0)
            + np.roll(x, -1, 1) + np.roll(x, 1, 1) - 4 * x
        )

    @pytest.mark.parametrize("axes", [(8, 1), (4, 2), (2, 4)])
    def test_matvec_matches_torus(self, axes):
        from neptune_tpu.parallel import shardmap_opdef

        n = 64
        self._torus_op(n)
        cm = ntp.get_context().compiled()
        gm = GridMesh(axes, ("x", "y"))
        mv = shardmap_opdef(cm, "lap_torus", gm)
        x = np.random.default_rng(11).standard_normal((n, n))
        got = np.asarray(jax.jit(mv)(gm.shard(jnp.asarray(x))))
        np.testing.assert_allclose(got, self._oracle(x), atol=1e-13)

    def test_sweeps_match_k_applications(self):
        from neptune_tpu.parallel import shardmap_sweeps

        n, k = 64, 3
        self._torus_op(n)
        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        fk = shardmap_sweeps(cm, "lap_torus", gm, k)
        x = np.random.default_rng(13).standard_normal((n, n))
        got = np.asarray(jax.jit(fk)(gm.shard(jnp.asarray(x))))
        want = x
        for _ in range(k):
            want = self._oracle(want)
        np.testing.assert_allclose(got, want, atol=1e-11)

    def test_wide_periodic_asymmetric(self):
        # 4th-order torus stencil on a mesh that shards only dim 0
        from neptune_tpu.parallel import shardmap_opdef

        n = 64

        @ntp.linear_op_def(bounds=([0, 0], [n, n]), periodic=True)
        def adv4_torus(u):
            return (
                u[2, 0] - 2.0 * u[1, 0] + u[-1, 0] - u[-2, 0]
                + u[0, 2] - 2.0 * u[0, 1] + u[0, -1] - u[0, -2]
            )

        cm = ntp.get_context().compiled()
        gm = GridMesh((8,), ("x",))
        mv = shardmap_opdef(cm, "adv4_torus", gm)
        x = np.random.default_rng(17).standard_normal((n, n))
        want = (
            np.roll(x, -2, 0) - 2 * np.roll(x, -1, 0) + np.roll(x, 1, 0)
            - np.roll(x, 2, 0)
            + np.roll(x, -2, 1) - 2 * np.roll(x, -1, 1) + np.roll(x, 1, 1)
            - np.roll(x, 2, 1)
        )
        got = np.asarray(jax.jit(mv)(gm.shard(jnp.asarray(x))))
        np.testing.assert_allclose(got, want, atol=1e-12)


class TestShardedNonlinearAndDriver:
    def test_sharded_newton_krylov(self):
        """JFNK on sharded fields: the residual closes over a shard_map
        matvec; jax.jvp differentiates through the ppermute exchange and
        the tree reductions become mesh all-reduces."""
        from neptune_tpu.parallel import shardmap_opdef
        from neptune_tpu.solvers import newton_krylov

        n = 64
        make_lap2d(n)
        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        mv = shardmap_opdef(cm, "lap2d", gm)
        b = np.zeros((n, n))
        b[1:-1, 1:-1] = np.random.default_rng(2).standard_normal((n - 2, n - 2))
        bs = gm.shard(jnp.asarray(b))

        def F(u):
            return mv(u) + 0.1 * u * u * u - bs

        x, info = jax.jit(lambda: newton_krylov(F, jnp.zeros((n, n))))()
        assert bool(info.converged)
        assert np.linalg.norm(np.asarray(F(x))) < 1e-7

    def test_sharded_driver_checkpoint_resume(self, tmp_path):
        """SimulationDriver over sharded state: checkpoints gather to host
        numpy transparently; a resumed run (which feeds the loaded host
        arrays back through shard_map) lands on the same trajectory."""
        from neptune_tpu.parallel import shardmap_sweeps
        from neptune_tpu.utils.driver import SimulationDriver

        n = 64

        @ntp.linear_op_def(bounds=([0, 0], [n, n]), periodic=True)
        def relax(u):
            return u[0, 0] + 0.1 * (
                u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4.0 * u[0, 0]
            )

        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        fk = shardmap_sweeps(cm, "relax", gm, 4)

        def step(state):
            return {"u": fk(state["u"])}

        u0 = np.random.default_rng(0).standard_normal((n, n))
        ckpt = tmp_path / "sim.npz"

        drv = SimulationDriver(step, ckpt, checkpoint_every=5)
        full, nf = drv.run({"u": gm.shard(jnp.asarray(u0))}, n_steps=12)
        assert nf == 12

        # simulate a crash after step 10: rewind the checkpoint, resume
        ckpt2 = tmp_path / "sim2.npz"
        drv2 = SimulationDriver(step, ckpt2, checkpoint_every=5)
        drv2.run(
            {"u": gm.shard(jnp.asarray(u0))},
            n_steps=10,
        )
        drv3 = SimulationDriver(step, ckpt2, checkpoint_every=5)
        resumed, nr = drv3.run({"u": gm.shard(jnp.asarray(u0))}, n_steps=12)
        assert nr == 12
        np.testing.assert_allclose(resumed["u"], full["u"], atol=1e-12)


class TestCommunicationVolume:
    """Pin the communication structure by counting collectives in the
    jaxpr: the fused strip path does one ppermute per (sharded dim, side)
    per application, and shardmap_sweeps does 1/K of the naive loop."""

    def test_ppermute_counts(self):
        from neptune_tpu.parallel import shardmap_opdef, shardmap_sweeps

        n = 64
        make_lap2d(n)
        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        x = gm.shard(jnp.zeros((n, n)))

        def count(fn, *args):
            return str(jax.make_jaxpr(fn)(*args)).count("ppermute")

        mv = shardmap_opdef(cm, "lap2d", gm)
        # 2 sharded dims x 2 sides
        assert count(mv, x) == 4

        def four(v):
            for _ in range(4):
                v = mv(v)
            return v

        assert count(four, x) == 16
        fk = shardmap_sweeps(cm, "lap2d", gm, 4)
        assert count(fk, x) == 4  # K sweeps, ONE exchange


class TestCAChebyshev:
    """Communication-avoiding Chebyshev: K solver iterations per exchange
    (`parallel.chebyshev_sharded`). The (x, r, d) recurrence is trapezoid-
    recomputed at shard edges, so the result matches the plain per-iteration
    exchange solver while issuing ~K-fold fewer exchange rounds."""

    def _setup(self, n=64):
        make_lap2d(n)
        cm = ntp.get_context().compiled()
        lmin = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (n + 1)))
        return cm, lmin, 8.0

    @pytest.mark.parametrize(
        "axes,k_fuse", [((4, 2), 8), ((8, 1), 4)]
    )  # (8,1): 8 local rows bound k_fuse*(lo+hi) <= 8
    def test_matches_plain_chebyshev(self, axes, k_fuse):
        from neptune_tpu.parallel import chebyshev_sharded, shardmap_opdef
        from neptune_tpu.solvers import chebyshev

        cm, lmin, lmax = self._setup()
        gm = GridMesh(axes, ("x", "y"))
        b = np.random.default_rng(12).standard_normal((64, 64))
        bs = gm.shard(jnp.asarray(b))
        solve = jax.jit(
            chebyshev_sharded(
                cm, "lap2d", gm, lam_min=lmin, lam_max=lmax,
                k_fuse=k_fuse, maxiter=800, tol=1e-9,
            )
        )
        x, info = solve(bs)
        assert bool(info.converged)
        mv = shardmap_opdef(cm, "lap2d", gm)
        xp, _ = jax.jit(
            lambda bb: chebyshev(
                mv, bb, lam_min=lmin, lam_max=lmax, maxiter=int(info.iters)
            )
        )(bs)
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(xp), atol=1e-12
        )
        # and it actually solves the system
        np.testing.assert_allclose(lap2d_np(np.asarray(x)), b, atol=1e-6)

    def test_jacobi_preconditioned(self):
        from neptune_tpu.parallel import chebyshev_sharded

        cm, _, _ = self._setup()
        gm = GridMesh((4, 2), ("x", "y"))
        b = np.random.default_rng(5).standard_normal((64, 64))
        bs = gm.shard(jnp.asarray(b))
        # D^-1 A of the 5-pt system: diagonal 4 in the interior, 1 on the
        # copy-through ring
        idiag = np.full((64, 64), 0.25)
        idiag[0, :] = idiag[-1, :] = idiag[:, 0] = idiag[:, -1] = 1.0
        ids = gm.shard(jnp.asarray(idiag))
        solve = jax.jit(
            chebyshev_sharded(
                cm, "lap2d", gm, lam_min=0.25 * 2.0 * (2.0 - 2.0 * np.cos(np.pi / 65)),
                lam_max=2.0, k_fuse=4, maxiter=800, tol=1e-9,
                inv_diag=np.asarray(idiag),
            )
        )
        x, info = solve(bs)
        assert bool(info.converged)
        np.testing.assert_allclose(lap2d_np(np.asarray(x)), b, atol=1e-6)

    def test_exchange_rounds(self):
        # serial exchange rounds drop ~K-fold: count ppermutes per solver
        # iteration in the jaxprs
        from neptune_tpu.parallel import chebyshev_sharded, shardmap_opdef
        from neptune_tpu.solvers import chebyshev

        cm, lmin, lmax = self._setup()
        gm = GridMesh((4, 2), ("x", "y"))
        bs = gm.shard(jnp.zeros((64, 64)))

        def count(fn, *args):
            return str(jax.make_jaxpr(fn)(*args)).count("ppermute")

        k, iters = 8, 96
        ca = chebyshev_sharded(
            cm, "lap2d", gm, lam_min=lmin, lam_max=lmax,
            k_fuse=k, maxiter=iters,
        )
        mv = shardmap_opdef(cm, "lap2d", gm)
        plain = lambda bb: chebyshev(
            mv, bb, lam_min=lmin, lam_max=lmax, maxiter=iters
        )
        n_ca, n_plain = count(ca, bs), count(plain, bs)
        # CA: 3 fields x 4 ppermutes per chunk (in ONE concurrent round)
        # inside a fori_loop body + the seeding exchange; plain: 4 per
        # iteration inside its loop body. The jaxpr counts are per-body:
        assert n_ca <= 3 * 4 + 4 + 4  # chunk body + seed
        assert n_plain >= 4


class TestShardmapMultigrid:
    def test_vcycle_over_shardmap_matvecs(self):
        """The MG hierarchy accepts bare matvec callables, so each level can
        run the explicit strip-exchange shardmap path instead of GSPMD —
        the configuration for real multi-chip meshes where the fused path's
        deterministic communication wins."""
        import sys

        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from test_multigrid import poisson_ops

        from neptune_tpu.parallel import shardmap_opdef
        from neptune_tpu.solvers import multigrid_solve

        poisson_ops([128, 64, 32, 16])
        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        mvs = [
            shardmap_opdef(cm, f"poisson{n}", gm) for n in (128, 64, 32, 16)
        ]
        b = np.zeros((128, 128))
        b[1:-1, 1:-1] = np.random.default_rng(0).standard_normal((126, 126))
        bs = gm.shard(jnp.asarray(b))
        x, info = multigrid_solve(mvs, bs, tol=1e-9, maxiter=60)
        assert bool(info.converged)
        assert int(info.iters) < 30  # multigrid rate, matvec-backend-agnostic


def test_ca_chebyshev_rank3():
    """CA-Chebyshev is rank-generic: 3-D 7-pt Poisson on a 2-axis mesh."""
    from neptune_tpu.parallel import chebyshev_sharded, shardmap_opdef
    from neptune_tpu.solvers import chebyshev

    m = 24

    @ntp.linear_op_def(
        bounds=([0, 0, 0], [m, m, m]),
        interior=([1, 1, 1], [m - 1, m - 1, m - 1]),
    )
    def lap3(u):
        return (
            6.0 * u[0, 0, 0]
            - u[1, 0, 0] - u[-1, 0, 0]
            - u[0, 1, 0] - u[0, -1, 0]
            - u[0, 0, 1] - u[0, 0, -1]
        )

    cm = ntp.get_context().compiled()
    gm = GridMesh((4, 2), ("x", "y"))
    lmin = 3.0 * (2.0 - 2.0 * np.cos(np.pi / (m + 1)))
    b = np.zeros((m, m, m))
    b[1:-1, 1:-1, 1:-1] = np.random.default_rng(4).standard_normal(
        (m - 2, m - 2, m - 2)
    )
    bs = gm.shard(jnp.asarray(b))
    solve = jax.jit(
        chebyshev_sharded(
            cm, "lap3", gm, lam_min=lmin, lam_max=12.0,
            k_fuse=3, maxiter=600, tol=1e-9,
        )
    )
    x, info = solve(bs)
    assert bool(info.converged)
    mv = shardmap_opdef(cm, "lap3", gm)
    xp, _ = jax.jit(
        lambda bb: chebyshev(
            mv, bb, lam_min=lmin, lam_max=12.0, maxiter=int(info.iters)
        )
    )(bs)
    np.testing.assert_allclose(np.asarray(x), np.asarray(xp), atol=1e-12)


def test_ca_chebyshev_early_stop():
    """check_every=c adds one psum per c*k_fuse iterations and stops the
    chunk loop at the first check that meets tol."""
    from neptune_tpu.parallel import chebyshev_sharded

    n = 64
    make_lap2d(n)
    cm = ntp.get_context().compiled()
    gm = GridMesh((4, 2), ("x", "y"))
    lmin = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (n + 1)))
    b = np.random.default_rng(12).standard_normal((n, n))
    bs = gm.shard(jnp.asarray(b))
    full = jax.jit(
        chebyshev_sharded(
            cm, "lap2d", gm, lam_min=lmin, lam_max=8.0,
            k_fuse=8, maxiter=2000, tol=1e-8,
        )
    )
    x0, i0 = full(bs)
    early = jax.jit(
        chebyshev_sharded(
            cm, "lap2d", gm, lam_min=lmin, lam_max=8.0,
            k_fuse=8, maxiter=2000, tol=1e-8, check_every=4,
        )
    )
    x1, i1 = early(bs)
    assert bool(i0.converged) and bool(i1.converged)
    assert int(i1.iters) < int(i0.iters) // 2
    # the early-stopped solution satisfies the tolerance for the true system
    xx = np.asarray(x1)
    res = b.copy()
    res[1:-1, 1:-1] -= (
        4 * xx[1:-1, 1:-1] - xx[:-2, 1:-1] - xx[2:, 1:-1]
        - xx[1:-1, :-2] - xx[1:-1, 2:]
    )
    res[0, :] -= xx[0, :]
    res[-1, :] -= xx[-1, :]
    res[1:-1, 0] -= xx[1:-1, 0]
    res[1:-1, -1] -= xx[1:-1, -1]
    assert np.linalg.norm(res) <= 1e-8 * np.linalg.norm(b) * 2


def test_ca_chebyshev_reduction_free_reports_true_residual():
    """Regression (round-3 review): the check_every=0 path used to report
    the drifted recurrence residual; the final report must rebase on the
    true b - A·x (solvers.chebyshev reduction-free parity), while the loop
    itself stays collective-free."""
    from neptune_tpu.parallel import chebyshev_sharded

    n = 128

    @ntp.linear_op_def(
        bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
        dtype="float32", name="lap_rf",
    )
    def lap_rf(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    cm = ntp.get_context().compiled()
    gm = GridMesh((4, 2), ("x", "y"))
    rng = np.random.default_rng(3)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.standard_normal((n - 2, n - 2)).astype(np.float32)
    lam_min = float(4 - 4 * np.cos(np.pi / (n - 1)))
    x, info = jax.jit(
        chebyshev_sharded(
            cm, "lap_rf", gm, lam_min=lam_min, lam_max=8.0,
            k_fuse=8, maxiter=4000, tol=4e-5, check_every=0,
        )
    )(gm.shard(jnp.asarray(b)))
    xx = np.asarray(x, np.float64)
    Ax = np.zeros_like(xx)
    Ax[1:-1, 1:-1] = (
        4 * xx[1:-1, 1:-1] - xx[:-2, 1:-1] - xx[2:, 1:-1]
        - xx[1:-1, :-2] - xx[1:-1, 2:]
    )
    Ax[0, :] = xx[0, :]
    Ax[-1, :] = xx[-1, :]
    Ax[1:-1, 0] = xx[1:-1, 0]
    Ax[1:-1, -1] = xx[1:-1, -1]
    true = float(np.linalg.norm(b - Ax))
    assert abs(float(info.resnorm) - true) / max(true, 1e-30) < 0.05


def test_ca_chebyshev_check_reports_true_residual():
    """The check path rebases the recurrence on the true b - A·x at every
    check boundary (one extra exchanged matvec), so at f32 over thousands
    of iterations the reported resnorm is the honest one — mirrors
    tests/test_chebyshev.py::TestResidualReplacement for the sharded CA
    loop, where the rebase matvec needs its own strip exchange."""
    from neptune_tpu.parallel import chebyshev_sharded

    n = 128

    @ntp.linear_op_def(
        bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
        dtype="float32",
    )
    def lap2d_f32(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    cm = ntp.get_context().compiled()
    gm = GridMesh((4, 2), ("x", "y"))
    rng = np.random.default_rng(7)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.standard_normal((n - 2, n - 2)).astype(np.float32)
    lam_min = float(4 - 4 * np.cos(np.pi / (n - 1)))
    x, info = jax.jit(
        chebyshev_sharded(
            cm, "lap2d_f32", gm, lam_min=lam_min, lam_max=8.0,
            k_fuse=8, maxiter=6000, tol=4e-5, check_every=12,
        )
    )(gm.shard(jnp.asarray(b)))
    xx = np.asarray(x, np.float64)
    Ax = np.zeros_like(xx)
    Ax[1:-1, 1:-1] = (
        4 * xx[1:-1, 1:-1] - xx[:-2, 1:-1] - xx[2:, 1:-1]
        - xx[1:-1, :-2] - xx[1:-1, 2:]
    )
    Ax[0, :] = xx[0, :]
    Ax[-1, :] = xx[-1, :]
    Ax[1:-1, 0] = xx[1:-1, 0]
    Ax[1:-1, -1] = xx[1:-1, -1]
    true = float(np.linalg.norm(b - Ax))
    bn = float(np.linalg.norm(b))
    assert bool(info.converged)
    assert abs(float(info.resnorm) - true) / true < 0.05
    assert true / bn <= 4e-5 * 1.05


class TestCAMultigrid:
    """Communication-avoiding V-cycle smoothing: each level's pre/post
    smoothers run k fused Chebyshev iterations per 1-2 halo exchange
    rounds via the trapezoid band machinery (ca_multigrid), with the
    pre-smoother's residual restricted straight out of the recurrence."""

    NAMES = ("poisson128", "poisson64", "poisson32", "poisson16")

    def _setup(self, k=3):
        import sys

        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from test_multigrid import poisson_ops

        from neptune_tpu.parallel import build_ca_levels

        poisson_ops([128, 64, 32, 16])
        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        lvls = build_ca_levels(
            cm, self.NAMES, gm, jnp.zeros((128, 128)), k=k
        )
        rng = np.random.default_rng(0)
        b = np.zeros((128, 128))
        b[1:-1, 1:-1] = rng.standard_normal((126, 126))
        bs = gm.shard(jnp.asarray(b))
        return cm, gm, lvls, b, bs

    def test_wide_stencil_diagonal_probe(self):
        """Regression (round-3 review): build_ca_levels' default matvecs
        are bare shardmap_opdef closures with no halo metadata, so
        build_levels used to probe the diagonal at period (1,1) — aliasing
        reach-2 taps INTO the diagonal (6 - 4 = 2 instead of 6 here) and
        silently degrading every smoother built from it."""
        from neptune_tpu.parallel import build_ca_levels

        n = 64

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([2, 2], [n - 2, n - 2]),
            name="wide5",
        )
        def wide5(u):
            return 6.0 * u[0, 0] - u[-2, 0] - u[2, 0] - u[0, -2] - u[0, 2]

        cm = ntp.get_context().compiled()
        gm = GridMesh((4, 2), ("x", "y"))
        lvls = build_ca_levels(cm, ["wide5"], gm, jnp.zeros((n, n)), k=2)
        d = np.asarray(lvls[0].inv_diag)
        np.testing.assert_allclose(d[2:-2, 2:-2], 1.0 / 6.0, atol=1e-12)
        # boundary copy-through rows are identity rows
        np.testing.assert_allclose(d[0, :], 1.0, atol=1e-12)
        np.testing.assert_allclose(d[:, -1], 1.0, atol=1e-12)

    def test_smoother_matches_chebyshev_trajectory(self):
        """k fused CA iterations == solvers.chebyshev at maxiter=k over the
        shardmap matvec, from both zero and live guesses, and the returned
        residual is the true b - A x' (pre-smoothing restricts it with no
        extra matvec)."""
        from neptune_tpu.parallel import ca_smoother, shardmap_opdef
        from neptune_tpu.solvers.chebyshev import chebyshev
        from neptune_tpu.solvers.multigrid import build_levels

        cm, gm, lvls, b, bs = self._setup()
        mv = shardmap_opdef(cm, "poisson128", gm)
        L = build_levels([mv], jnp.zeros((128, 128)))[0]
        lmax = float(L.cheb_lmax)
        k = 3
        sm, sm0 = ca_smoother(
            cm, "poisson128", gm, k=k,
            lam_min=lmax / 4, lam_max=lmax, inv_diag=L.inv_diag,
        )

        def oracle(bb, x0):
            y, _ = chebyshev(
                mv, bb, x0=x0, M=lambda v: L.inv_diag * v,
                lam_min=lmax / 4, lam_max=lmax, maxiter=k,
                residual_replacement=False,
            )
            return y

        x_ca, r_ca = jax.jit(sm0)(bs)
        x_or = jax.jit(oracle)(bs, jnp.zeros_like(bs))
        np.testing.assert_allclose(
            np.asarray(x_ca), np.asarray(x_or), atol=1e-13
        )
        np.testing.assert_allclose(
            np.asarray(r_ca), np.asarray(bs - mv(x_ca)), atol=1e-10
        )

        x1 = gm.shard(
            jnp.asarray(np.random.default_rng(1).standard_normal((128, 128)))
        )
        x_ca2, r_ca2 = jax.jit(sm)(bs, x1)
        x_or2 = jax.jit(oracle)(bs, x1)
        np.testing.assert_allclose(
            np.asarray(x_ca2), np.asarray(x_or2), atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(r_ca2), np.asarray(bs - mv(x_ca2)), atol=1e-9
        )

    def test_convergence_unchanged(self):
        """CA-smoothed MG solves in the SAME iteration count (same math) as
        per-matvec cheb smoothing, to the same solution."""
        from neptune_tpu.parallel import shardmap_opdef
        from neptune_tpu.solvers import multigrid_solve

        cm, gm, lvls, b, bs = self._setup(k=3)
        assert [lv.ca_smooth is not None for lv in lvls] == [
            True, True, True, False,  # 16^2 over (4,2): band exceeds shard
        ]
        x, info = multigrid_solve(
            [None] * 4, bs, tol=1e-9, maxiter=60,
            levels=lvls, smoother="cheb", pre=3, post=3,
        )
        mvs = [shardmap_opdef(cm, nm, gm) for nm in self.NAMES]
        x_ref, info_ref = multigrid_solve(
            mvs, bs, tol=1e-9, maxiter=60, smoother="cheb", pre=3, post=3
        )
        assert bool(info.converged) and bool(info_ref.converged)
        assert int(info.iters) == int(info_ref.iters)
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(x_ref), atol=1e-12
        )

    def test_exchange_rounds_cut(self):
        """The CA property: one smoothing pass's communication is a single
        strip-exchange round — its ppermute count is CONSTANT in the
        smoothing degree k, while a per-matvec smoother must issue k
        exchange rounds (4 ppermutes each on a 2-axis mesh)."""
        from neptune_tpu.parallel import ca_smoother, shardmap_opdef
        from neptune_tpu.solvers.multigrid import build_levels

        cm, gm, lvls, b, bs = self._setup(k=3)
        mv = shardmap_opdef(cm, "poisson128", gm)
        L = build_levels([mv], jnp.zeros((128, 128)))[0]
        lmax = float(L.cheb_lmax)

        def count(f, *a):
            return str(jax.make_jaxpr(f)(*a)).count("ppermute")

        counts = {}
        for k in (2, 6):
            _, sm0 = ca_smoother(
                cm, "poisson128", gm, k=k,
                lam_min=lmax / 4, lam_max=lmax, inv_diag=L.inv_diag,
            )
            counts[k] = count(sm0, bs)

        # (x, r) strips + the iteration-constant inv_diag strips: 3 fields
        # x 2 sharded dims x 2 sides = 12 ppermutes, independent of k
        assert counts[2] == counts[6] == 12, counts

        def naive(k):
            def f(v):
                for _ in range(k):
                    v = mv(v)
                return v
            return f

        assert count(naive(6), bs) == 24  # k exchange rounds: 4 each
        assert counts[6] < count(naive(6), bs)

    def test_ca_mg_preconditions_cg(self):
        """The CA cycle stays a fixed linear, D-self-adjoint operator:
        CG with it converges at multigrid rate."""
        from neptune_tpu.parallel import shardmap_opdef
        from neptune_tpu.solvers import cg, mg_preconditioner

        cm, gm, lvls, b, bs = self._setup(k=2)
        mv = shardmap_opdef(cm, "poisson128", gm)
        M = mg_preconditioner([None], bs, smoother="cheb", levels=lvls)

        @jax.jit
        def solve(bb):
            return cg(mv, bb, M=M, tol=1e-8, maxiter=200)

        x, info = solve(bs)
        assert bool(info.converged)
        assert int(info.iters) < 40  # multigrid-rate, not CG-rate
