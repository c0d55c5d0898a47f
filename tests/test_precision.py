"""Matmul-precision pinning in the CA solver family.

A default-precision f32 matmul may multiply at reduced precision (TF32 on
NVIDIA tensor cores). The CA solvers run their recurrences in coefficient
space through Gram matrices — at reduced multiply precision the residual
estimates stall orders above tol, or the Chebyshev basis NaNs. Every
Gram/coefficient/recombination matmul therefore pins
`precision="highest"` (`ca_common._mm`).

The CPU is always f32-exact, so these tests guard
the fix structurally: trace each sharded solver and assert every
`dot_general` equation in the jaxpr carries HIGHEST precision.
"""

import jax
import jax.numpy as jnp
import pytest

import neptune_tpu as ntp
from neptune_tpu.parallel import (
    GridMesh,
    bicgstab_sharded,
    cg_sharded,
    gmres_sharded,
)
from tests.test_ca_cg import make_lap2d  # shared 2-D Poisson builder

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs 2 virtual devices"
)


@pytest.fixture(autouse=True)
def fresh():
    ntp.reset_context()
    yield
    ntp.reset_context()


def _walk_dot_generals(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            objs = v if isinstance(v, (tuple, list)) else (v,)
            for o in objs:
                inner = getattr(o, "jaxpr", None)
                if inner is not None:
                    _walk_dot_generals(inner, out)
                elif hasattr(o, "eqns"):
                    _walk_dot_generals(o, out)
    return out


def _assert_all_highest(solver_fn):
    n = 64
    cm = make_lap2d(n)
    gm = GridMesh((2,), ("x",))
    b = jnp.zeros((n, n))
    solve = solver_fn(cm, gm)
    jaxpr = jax.make_jaxpr(solve)(gm.shard(b))
    dots = _walk_dot_generals(jaxpr.jaxpr, [])
    assert dots, "expected coefficient-space matmuls in the traced solve"
    for eqn in dots:
        prec = eqn.params.get("precision")
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST
            for p in (prec if isinstance(prec, tuple) else (prec,))
        ), f"unpinned dot_general in solver trace: precision={prec}"


class TestPinnedMatmulPrecision:
    def test_ca_cg(self):
        _assert_all_highest(
            lambda cm, gm: cg_sharded(cm, "lap2d", gm, s=2, maxiter=8, tol=1e-4)
        )

    def test_ca_gmres(self):
        _assert_all_highest(
            lambda cm, gm: gmres_sharded(
                cm, "lap2d", gm, s=2, maxiter=8, tol=1e-4
            )
        )

    def test_ca_bicgstab(self):
        _assert_all_highest(
            lambda cm, gm: bicgstab_sharded(
                cm, "lap2d", gm, s=2, maxiter=8, tol=1e-4
            )
        )
