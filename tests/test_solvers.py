"""Solver-layer tests against NumPy/SciPy-style dense oracles at 1e-10.

The accuracy bar comes from BASELINE.md ("match reference CPU outputs to
1e-10") and the reference's solver contracts (GMRES tol 1e-8..1e-10, Newton
tol 1e-10; `test/smoke_tests/smoke_time_advance*.mlir`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neptune_tpu.solvers import (
    MatrixHandle,
    bicgstab,
    cg,
    extract_diagonal,
    gmres,
    jacobi,
    newton_krylov,
    picard,
    ssor_dense,
)
from neptune_tpu.ir import Bounds, TempType


@pytest.fixture
def lap1d():
    n = 64

    def matvec(x):
        return 2 * x - jnp.roll(x, 1).at[0].set(0) - jnp.roll(x, -1).at[-1].set(0)

    A = (
        np.diag(2 * np.ones(n))
        - np.diag(np.ones(n - 1), 1)
        - np.diag(np.ones(n - 1), -1)
    )
    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.standard_normal(n))
    x_ref = np.linalg.solve(A, np.asarray(b))
    return matvec, A, b, x_ref


class TestKrylov:
    def test_cg(self, lap1d):
        matvec, A, b, x_ref = lap1d
        x, info = cg(matvec, b, tol=1e-13, maxiter=500)
        assert bool(info.converged)
        np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-10)

    def test_cg_jacobi_preconditioned(self, lap1d):
        matvec, A, b, x_ref = lap1d
        M = jacobi(matvec, jnp.zeros(64), ((1, 1),))
        x, info = cg(matvec, b, tol=1e-13, maxiter=500, M=M)
        assert bool(info.converged)
        np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-10)

    def test_cg_ssor_preconditioned(self, lap1d):
        matvec, A, b, x_ref = lap1d
        M = ssor_dense(jnp.asarray(A))
        x, info = cg(matvec, b, tol=1e-13, maxiter=500, M=M)
        assert bool(info.converged)
        assert int(info.iters) < 64  # SSOR must actually accelerate CG
        np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-10)

    def test_bicgstab_nonsymmetric(self):
        n = 48
        A = np.zeros((n, n))
        for i in range(n):
            A[i, i] = 3.0
            if i > 0:
                A[i, i - 1] = -2.0
            if i < n - 1:
                A[i, i + 1] = -0.5
        Aj = jnp.asarray(A)

        def matvec(x):
            return Aj @ x

        rng = np.random.default_rng(3)
        b = jnp.asarray(rng.standard_normal(n))
        x_ref = np.linalg.solve(A, np.asarray(b))
        x, info = bicgstab(matvec, b, tol=1e-13, maxiter=500)
        assert bool(info.converged)
        np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-9)

    def test_gmres_nonsymmetric(self):
        n = 48
        A = np.zeros((n, n))
        for i in range(n):
            A[i, i] = 3.0
            if i > 0:
                A[i, i - 1] = -2.0
            if i < n - 1:
                A[i, i + 1] = -0.5
        Aj = jnp.asarray(A)

        def matvec(x):
            return Aj @ x

        rng = np.random.default_rng(3)
        b = jnp.asarray(rng.standard_normal(n))
        x_ref = np.linalg.solve(A, np.asarray(b))
        x, info = gmres(matvec, b, tol=1e-12, maxiter=300, restart=30)
        assert bool(info.converged)
        np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-9)

    def test_gmres_respects_maxiter_budget(self):
        # maxiter is a hard budget (newton_krylov inner solves rely on
        # it): restarted GMRES must not overrun it by up to restart-1
        # iterations when maxiter is not a multiple of restart
        n = 64
        A = np.diag(np.linspace(1.0, 50.0, n))
        Aj = jnp.asarray(A)
        b = jnp.asarray(np.random.default_rng(5).standard_normal(n))
        x, info = gmres(
            lambda v: Aj @ v, b, tol=0.0, maxiter=45, restart=30
        )
        assert int(info.iters) <= 45, int(info.iters)

    def test_gmres_full_converges_in_n(self, lap1d):
        matvec, A, b, x_ref = lap1d
        x, info = gmres(matvec, b, tol=1e-11, maxiter=200, restart=64)
        assert int(info.iters) <= 64 + 1
        np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-8)

    def test_zero_rhs(self, lap1d):
        matvec, A, b, x_ref = lap1d
        x, info = cg(matvec, jnp.zeros(64), tol=1e-12, maxiter=10)
        assert np.all(np.asarray(x) == 0)

    def test_solvers_jittable(self, lap1d):
        matvec, A, b, x_ref = lap1d

        @jax.jit
        def solve(b):
            return cg(matvec, b, tol=1e-13, maxiter=500)[0]

        np.testing.assert_allclose(np.asarray(solve(b)), x_ref, atol=1e-10)


class TestSSORStencil:
    """Matrix-free red-black SSOR (VERDICT r3 missing #1: the dense-only
    SSOR capped at toy sizes; north star names matrix-free Jacobi/SSOR)."""

    def _poisson(self, n, name="pssor"):
        import neptune_tpu as ntp

        ntp.reset_context()

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]),
            interior=([1, 1], [n - 1, n - 1]),
            dtype="float64",
            name=name,
        )
        def pssor(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        return ntp.assemble_matrix(pssor)

    @pytest.mark.parametrize("omega", [1.0, 1.5])
    def test_matches_rb_permuted_dense(self, omega):
        """Oracle: dense SSOR factorization of A permuted into red-first
        ordering (red-black SSOR is SSOR in that ordering, NOT in natural
        row-major order — a different, equally valid preconditioner)."""
        from neptune_tpu.solvers.precond import _red_mask_np, ssor_stencil

        n = 16
        H = self._poisson(n)
        A = np.asarray(H.dense())
        red = _red_mask_np((n, n)).ravel()
        perm = np.concatenate([np.where(red)[0], np.where(~red)[0]])
        Ap = A[np.ix_(perm, perm)]
        D = np.diag(Ap)
        Dsafe = np.where(D == 0, 1.0, D)
        L, U = np.tril(Ap, -1), np.triu(Ap, 1)
        rng = np.random.default_rng(3)
        r = rng.standard_normal(n * n)
        a = np.linalg.solve(np.diag(Dsafe) / omega + L, r[perm])
        z = np.linalg.solve(np.diag(Dsafe) / omega + U, Dsafe * a)
        want = np.zeros(n * n)
        want[perm] = omega * (2.0 - omega) * z

        M = ssor_stencil(
            H.matvec, jnp.zeros((n, n)), H.halo, omega=omega
        )
        got = np.asarray(M(jnp.asarray(r.reshape(n, n)))).ravel()
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_accelerates_cg_at_scale(self):
        """512^2 — far past any dense-assembly size (the round-3 gap)."""
        from neptune_tpu.solvers.precond import ssor_stencil

        n = 512
        import neptune_tpu as ntp

        ntp.reset_context()

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]),
            interior=([1, 1], [n - 1, n - 1]),
            dtype="float64",
            name="pbig",
        )
        def pbig(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        H = ntp.assemble_matrix(pbig)
        mv, halo = H.matvec, H.halo
        rng = np.random.default_rng(0)
        b = jnp.asarray(rng.standard_normal((n, n)))
        x0, i0 = cg(mv, b, tol=1e-8, maxiter=3000)
        M = ssor_stencil(mv, jnp.zeros((n, n)), halo)
        x1, i1 = cg(mv, b, tol=1e-8, maxiter=3000, M=M)
        assert bool(i1.converged)
        assert int(i1.iters) < int(i0.iters) / 2, (
            f"ssor {int(i1.iters)} vs none {int(i0.iters)}"
        )
        r = b - mv(x1)
        assert float(jnp.linalg.norm(r)) <= 1e-8 * float(
            jnp.linalg.norm(b)
        ) * 1.01

    def test_make_preconditioner_routes_matrix_free(self):
        """precond='ssor' no longer requires an assembled matrix."""
        from neptune_tpu.solvers.precond import make_preconditioner

        H = self._poisson(16)
        M = make_preconditioner(
            "ssor", H.matvec, jnp.zeros((16, 16)), H.halo
        )
        assert M is not None
        with pytest.raises(ValueError, match="requires an assembled"):
            make_preconditioner(
                "ssor_dense", H.matvec, jnp.zeros((16, 16)), H.halo
            )

    def test_solve_linear_precond_ssor_eager(self):
        import neptune_tpu as ntp

        H = self._poisson(48)
        rng = np.random.default_rng(1)
        b = rng.standard_normal((48, 48))
        x = ntp.solve_linear(
            H, b, solver="cg", tol=1e-10, max_iters=2000, precond="ssor",
            options={"omega": 1.2},
        )
        r = b - np.asarray(H.matvec(jnp.asarray(x)))
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b) * 1.01


class TestDiagonalProbing:
    def test_1d_tridiagonal(self, lap1d):
        matvec, A, b, x_ref = lap1d
        d = extract_diagonal(matvec, jnp.zeros(64), ((1, 1),))
        np.testing.assert_allclose(np.asarray(d), np.diag(A), atol=1e-14)

    def test_2d_5pt(self):
        n = 16

        def matvec(x):
            return (
                4 * x
                - jnp.roll(x, 1, 0)
                - jnp.roll(x, -1, 0)
                - jnp.roll(x, 1, 1)
                - jnp.roll(x, -1, 1)
            )

        d = extract_diagonal(matvec, jnp.zeros((n, n)), ((1, 1), (1, 1)))
        np.testing.assert_allclose(np.asarray(d), 4 * np.ones((n, n)), atol=1e-14)

    def test_variable_coefficient(self):
        n = 32
        c = jnp.asarray(np.random.default_rng(0).uniform(1, 2, n))

        def matvec(x):
            return c * x - 0.5 * jnp.roll(x, 1).at[0].set(0)

        d = extract_diagonal(matvec, jnp.zeros(n), ((1, 0),))
        np.testing.assert_allclose(np.asarray(d), np.asarray(c), atol=1e-14)


class TestNewton:
    def test_scalar_field_newton(self, lap1d):
        matvec, A, b, x_ref = lap1d

        def F(u):
            return matvec(u) + u**3 - b

        x, info = newton_krylov(
            F, jnp.zeros(64), tol=1e-12, krylov_tol=1e-10, krylov_iters=300
        )
        assert bool(info.converged)
        assert float(jnp.abs(F(x)).max()) < 1e-10

    def test_tuple_state_newton(self):
        # multi-field state: the test_swe_implicit.py (h, q) API shape
        def F(state):
            h, q = state
            return (h + 0.1 * q**2 - 1.0, q + 0.05 * h * q - 0.5)

        (h, q), info = newton_krylov(F, (jnp.ones(8), jnp.zeros(8)), tol=1e-13)
        assert bool(info.converged)
        r1, r2 = F((h, q))
        assert float(jnp.abs(r1).max()) < 1e-11
        assert float(jnp.abs(r2).max()) < 1e-11

    def test_newton_jittable(self):
        def F(u):
            return u**3 + u - 2.0

        @jax.jit
        def solve(u0):
            return newton_krylov(F, u0, tol=1e-13)[0]

        x = solve(jnp.ones(4))
        np.testing.assert_allclose(np.asarray(x), 1.0, atol=1e-12)

    def test_picard(self):
        # F(x) = x - cos(x) = 0 at the Dottie number; damped Richardson
        # iteration x <- x - w F(x) reduces to the classic fixed point at w=1
        def F(x):
            return x - jnp.cos(x)

        x, info = picard(F, jnp.zeros(4), tol=1e-12, max_iters=200)
        np.testing.assert_allclose(np.asarray(x), 0.7390851332151607, atol=1e-10)
        assert bool(info.converged)


class TestMatrixHandle:
    def test_dense_assembly(self):
        bounds = Bounds.of([0], [8])
        tt = TempType("float64", bounds)

        def matvec(x):
            return 2 * x - jnp.roll(x, 1).at[0].set(0) - jnp.roll(x, -1).at[-1].set(0)

        h = MatrixHandle("A", matvec, tt, halo=((1, 1),))
        A = np.asarray(h.dense())
        expected = (
            np.diag(2 * np.ones(8))
            - np.diag(np.ones(7), 1)
            - np.diag(np.ones(7), -1)
        )
        np.testing.assert_allclose(A, expected, atol=1e-14)

    def test_diagonal(self):
        bounds = Bounds.of([0], [8])
        tt = TempType("float64", bounds)

        def matvec(x):
            return 5 * x

        h = MatrixHandle("B", matvec, tt, halo=((0, 0),))
        np.testing.assert_allclose(np.asarray(h.diagonal()), 5.0, atol=1e-14)

    def test_2d_handle(self):
        bounds = Bounds.of([0, 0], [4, 4])
        tt = TempType("float64", bounds)

        def matvec(x):
            return 4 * x - jnp.roll(x, 1, 0) - jnp.roll(x, -1, 1)

        h = MatrixHandle("C", matvec, tt, halo=((1, 1), (1, 1)))
        assert h.n == 16
        A = np.asarray(h.dense())
        x = np.random.default_rng(1).standard_normal((4, 4))
        np.testing.assert_allclose(
            A @ x.ravel(), np.asarray(matvec(jnp.asarray(x))).ravel(), atol=1e-13
        )


class TestDirichletLift:
    """Round-4 fix: preconditioned CG with nonzero boundary (copy-through
    ring) data in b stalled ~5 digits short of tight tolerances — the ring
    makes A nonsymmetric and a non-uniform M breaks CG's M-symmetry. The
    solve paths now lift the ring data out (MatrixHandle.ring_lift: one
    extra matvec, exact), keeping the iterates in the symmetric interior
    subspace."""

    def _handle(self, n=32):
        import neptune_tpu as ntp

        ntp.reset_context()

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
            dtype="float64", name="plift",
        )
        def plift(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        return ntp.assemble_matrix(plift)

    @pytest.mark.parametrize("pc", ["jacobi", "ssor"])
    def test_preconditioned_cg_with_boundary_data(self, pc):
        import neptune_tpu as ntp

        H = self._handle()
        rng = np.random.default_rng(0)
        b = rng.standard_normal((32, 32))  # nonzero ring values
        x = ntp.solve_linear(
            H, b, solver="cg", tol=1e-10, max_iters=2000, precond=pc
        )
        x_ref = np.linalg.solve(np.asarray(H.dense()), b.ravel()).reshape(32, 32)
        np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-8)

    def test_ring_lift_shape(self):
        H = self._handle()
        b = jnp.asarray(np.arange(32 * 32, dtype=np.float64).reshape(32, 32))
        lift = H.ring_lift(b)
        assert lift is not None
        l = np.asarray(lift)
        assert np.array_equal(l[0, :], np.asarray(b)[0, :])  # ring kept
        assert np.all(l[1:-1, 1:-1] == 0)  # interior zeroed

    def test_full_domain_has_no_lift(self):
        import neptune_tpu as ntp

        ntp.reset_context()

        @ntp.linear_op_def(
            bounds=([0, 0], [16, 16]), dtype="float64", periodic=True,
            name="full",
        )
        def full(u):
            return 2.0 * u[0, 0] - 0.2 * (u[-1, 0] + u[1, 0])

        H = ntp.assemble_matrix(full)
        assert H.ring_lift(jnp.ones((16, 16))) is None


class TestCgSolveLinear:
    """solve_linear(solver="cg") on f32 2-D Poisson operators at 64²,
    plain, Jacobi-preconditioned and composite, with the true residual
    recomputed by the NumPy stencil."""

    @staticmethod
    def _poisson(n, name):
        import neptune_tpu as ntp

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
            dtype="float32", name=name,
        )
        def poisson(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        return poisson

    @pytest.mark.parametrize("precond", ["none", "jacobi"])
    def test_poisson_f32(self, precond):
        import neptune_tpu as ntp
        import np_oracle

        ntp.reset_context()
        n = 64
        H = ntp.assemble_matrix(self._poisson(n, f"p_{precond}"))
        b = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
        x = np.asarray(ntp.solve_linear(
            H, b, solver="cg", tol=1e-5, max_iters=2000, precond=precond
        ))
        r = b - np_oracle.linear(x, np_oracle.LAP5, np_oracle.interior((n, n), 1))
        assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b)
        ntp.reset_context()

    def test_same_iterations_as_solvers_cg(self):
        # solve_linear's CG is solvers.cg on the opdef: same recursion, same
        # iteration count, same iterate
        import neptune_tpu as ntp

        ntp.reset_context()
        self._poisson(64, "poisson")
        cm = ntp.get_context().compiled()
        mv = cm.opdef("poisson")
        # zero boundary ring: no Dirichlet lift, so the recursions coincide
        bh = np.zeros((64, 64), np.float32)
        bh[1:-1, 1:-1] = np.random.default_rng(0).standard_normal((62, 62))
        b = jnp.asarray(bh)
        x1, info = cg(mv, b, tol=1e-5, maxiter=2000)
        x2 = ntp.solve_linear(
            ntp.assemble_matrix("poisson"), b, solver="cg", tol=1e-5,
            max_iters=int(info.iters),
        )
        assert bool(info.converged)
        np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), atol=1e-4)
        ntp.reset_context()

    def test_composite_operator(self):
        # ac_A-style: x + 0.1 * lap_in(x), lap_in another linear opdef
        import neptune_tpu as ntp
        import np_oracle
        from neptune_tpu.ir import F32

        ntp.reset_context()
        n = 64

        @ntp.linear_op_def(
            bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
            dtype="float32", name="lap_in",
        )
        def lap_in(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        ctx = ntp.get_context()
        bld = ctx.builder
        tt = TempType("float32", Bounds.of([0, 0], [n, n]))
        fn = bld.make_opdef("shifted", "linear_opdef", [tt], [tt])
        bld.push_block(fn.body)
        lapx = bld.apply_linear("lap_in", [fn.body.args[0]])
        op, body = bld.start_apply([fn.body.args[0], lapx], tt.bounds)
        bld.push_block(body)
        x0 = bld.access(body.args[2], [0, 0])
        l0 = bld.access(body.args[3], [0, 0])
        bld.yield_(bld.add(x0, bld.mul(bld.constant(0.1, F32), l0)))
        bld.pop_block()
        bld.return_([bld.finish_apply(op)])
        bld.pop_block()
        ctx.bump()

        b = np.random.default_rng(2).standard_normal((n, n)).astype(np.float32)
        x = np.asarray(ntp.solve_linear(
            ntp.assemble_matrix("shifted"), b, solver="cg", tol=1e-5,
            max_iters=2000,
        ))
        ax = x + 0.1 * np_oracle.linear(
            x, np_oracle.LAP5, np_oracle.interior((n, n), 1)
        )
        assert np.linalg.norm(b - ax) <= 1e-4 * np.linalg.norm(b)
        ntp.reset_context()
