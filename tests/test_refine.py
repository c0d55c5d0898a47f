"""Mixed-precision iterative refinement tests (solvers.refine +
passes.retype): f64 accuracy from f32 inner solves — the answer to SURVEY.md
§7 hard part (e) (f64 is slower than f32 on most accelerators)."""

import jax.numpy as jnp
import numpy as np
import pytest

import neptune_tpu as ntp
from neptune_tpu.passes.retype import retype_module
from neptune_tpu.solvers.refine import refined_solve


@pytest.fixture(autouse=True)
def fresh():
    ntp.reset_context()
    yield
    ntp.reset_context()


def make_poisson(n=64):
    @ntp.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]))
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    return poisson


class TestRetype:
    def test_retyped_module_is_f32(self):
        make_poisson()
        m32 = retype_module(ntp.get_context().module, "float32")
        fn = m32.lookup("poisson")
        assert fn.ftype.inputs[0].element == "float32"
        for op in fn.walk():
            for r in op.results:
                el = getattr(r.type, "element", getattr(r.type, "name", None))
                assert el != "float64"

    def test_original_untouched(self):
        make_poisson()
        m = ntp.get_context().module
        retype_module(m, "float32")
        assert m.lookup("poisson").ftype.inputs[0].element == "float64"

    def test_twin_matches_values(self):
        make_poisson()
        cm = ntp.get_context().compiled()
        x = np.random.default_rng(0).standard_normal((64, 64))
        hi = np.asarray(cm.opdef("poisson")(x))
        lo = np.asarray(cm.low_precision_opdef("poisson")(x.astype(np.float32)))
        assert lo.dtype == np.float32
        np.testing.assert_allclose(lo, hi, atol=1e-4)


class TestRefinedSolve:
    def test_f64_accuracy_from_f32_inner(self):
        make_poisson()
        cm = ntp.get_context().compiled()
        hi = cm.opdef("poisson")
        lo = cm.low_precision_opdef("poisson")
        b = jnp.asarray(np.random.default_rng(1).standard_normal((64, 64)))
        x, info = refined_solve(
            hi, lo, b, solver="cg", tol=1e-12, inner_tol=1e-5, inner_iters=3000
        )
        assert x.dtype == jnp.float64
        assert bool(info.converged)
        res = float(jnp.linalg.norm(b - hi(x)))
        # beyond f32 machine precision — proves the refinement worked
        assert res < 1e-11 * float(jnp.linalg.norm(b)) * 10

    def test_dsl_precision_mixed(self):
        p = make_poisson()
        H = ntp.assemble_matrix(p)
        b = np.random.default_rng(2).standard_normal((64, 64))
        x = np.asarray(
            ntp.solve_linear(
                H, b, solver="cg", tol=1e-12, max_iters=3000,
                precond="jacobi", precision="mixed",
            )
        )
        assert x.dtype == np.float64
        r = b.copy()
        r[1:-1, 1:-1] -= (
            4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1]
            - x[1:-1, :-2] - x[1:-1, 2:]
        )
        r[0, :] -= x[0, :]
        r[-1, :] -= x[-1, :]
        r[1:-1, 0] -= x[1:-1, 0]
        r[1:-1, -1] -= x[1:-1, -1]
        assert np.abs(r).max() < 1e-10

    def test_traced_precision_mixed(self):
        p = make_poisson()

        @ntp.jit_class
        class S:
            def __init__(self):
                self.H = ntp.assemble_matrix(p)

            def solve(self, b):
                return ntp.solve_linear(
                    self.H, b, solver="cg", tol=1e-12, max_iters=3000,
                    precision="mixed",
                )

        s = S()
        b = np.random.default_rng(3).standard_normal((64, 64))
        x = np.asarray(s.solve(b))
        r = b[1:-1, 1:-1] - (
            4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1]
            - x[1:-1, :-2] - x[1:-1, 2:]
        )
        assert np.abs(r).max() < 1e-9
