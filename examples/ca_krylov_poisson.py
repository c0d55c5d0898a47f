"""s-step (communication-avoiding) Krylov solves on a sharded Poisson problem.

Per-iteration distributed CG pays one halo exchange + two psum rounds per
iteration; on a device mesh those collective latencies, not bandwidth, bound
small-iteration solvers. The CA solvers restructure the same mathematics:

  cg_sharded     one K-deep strip exchange + ONE (2s+1)^2 Gram psum per s
                 iterations (matrix-powers basis + coefficient-space CG,
                 true-residual reseeding every outer block)
  gmres_sharded  one exchange + ONE psum per restart cycle (the reference's
                 default KSP is GMRES: NeptunePETScRuntime.cpp:146-149)

Both report an honest final residual (one extra exchanged matvec), so
`info.resnorm` is the true ||b - A x||, never a coefficient-space estimate.

Run (single device works; to simulate 8 chips on CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/ca_krylov_poisson.py --cpu
"""

import sys

import numpy as np

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp

import neptune_tpu as ntp
from neptune_tpu.parallel import (
    GridMesh,
    bicgstab_sharded,
    cg_sharded,
    gmres_sharded,
    shardmap_opdef,
)
from neptune_tpu.solvers import cg

N = 128
DTYPE = "float32"  # the CA paths are f32-first; honest reporting keeps
# the claimed residual truthful at this precision


@ntp.linear_op_def(
    bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]), dtype=DTYPE
)
def poisson(u):
    return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]


def main():
    n_dev = len(jax.devices())
    a = next(c for c in range(int(n_dev**0.5), 0, -1) if n_dev % c == 0)
    gm = GridMesh((n_dev // a, a), ("x", "y"))
    print(f"devices: {n_dev}, mesh {gm.shape}")

    cm = ntp.get_context().compiled()
    rng = np.random.default_rng(0)
    b = np.zeros((N, N), np.float32)
    b[1:-1, 1:-1] = rng.standard_normal((N - 2, N - 2)).astype(np.float32)
    bs = gm.shard(jnp.asarray(b))
    bn = float(np.linalg.norm(b))
    tol = 1e-4  # the f32 recurrence floor for this conditioning

    # baseline: per-iteration CG over the explicit shard_map matvec
    mv = jax.jit(shardmap_opdef(cm, "poisson", gm))
    x0, info0 = jax.jit(lambda bb: cg(mv, bb, tol=tol, maxiter=4000))(bs)
    print(
        f"per-iteration CG: iters={int(info0.iters)} "
        f"rel_res={float(info0.resnorm) / bn:.2e} "
        f"(1 exchange + 2 psum rounds per iteration)"
    )

    # s-step CA-CG: chebyshev basis keeps the Gram matrix well-conditioned
    # at s > ~4 (a monomial basis degrades as kappa^s)
    lam_min = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (N + 1)))
    solve_cacg = jax.jit(
        cg_sharded(
            cm, "poisson", gm, s=8, maxiter=4000, tol=tol,
            basis="chebyshev", lam_min=lam_min, lam_max=8.0,
        )
    )
    x1, info1 = solve_cacg(bs)
    print(
        f"CA-CG (s=8):      iters={int(info1.iters)} "
        f"rel_res={float(info1.resnorm) / bn:.2e} "
        f"(1 exchange + 1 psum per 8 iterations)"
    )

    # CA-GMRES(s): the nonsymmetric-capable default, one psum per cycle
    solve_cagm = jax.jit(
        gmres_sharded(
            cm, "poisson", gm, s=8, maxiter=6000, tol=tol,
            basis="chebyshev", lam_min=lam_min, lam_max=8.0,
        )
    )
    x2, info2 = solve_cagm(bs)
    print(
        f"CA-GMRES(8):      iters={int(info2.iters)} "
        f"rel_res={float(info2.resnorm) / bn:.2e} "
        f"(1 exchange + 1 psum per cycle)"
    )

    # CA-BiCGStab: the trio's nonsymmetric workhorse (chains run 2s+1 deep,
    # so s stays small — one exchange + one psum per 2 iterations here)
    solve_cabi = jax.jit(
        bicgstab_sharded(cm, "poisson", gm, s=2, maxiter=4000, tol=tol)
    )
    x3, info3 = solve_cabi(bs)
    print(
        f"CA-BiCGStab(s=2): iters={int(info3.iters)} "
        f"rel_res={float(info3.resnorm) / bn:.2e} "
        f"(1 exchange + 1 psum per 2 iterations)"
    )

    # every reported residual must be the TRUE residual of the returned x
    for name, x, info in (
        ("cg", x0, info0), ("ca_cg", x1, info1), ("ca_gmres", x2, info2),
        ("ca_bicgstab", x3, info3),
    ):
        assert bool(info.converged), name
        true = float(jnp.linalg.norm(bs - mv(x)))
        rep = float(info.resnorm)
        assert true <= tol * bn * 1.6, (name, true / bn)
        assert abs(rep - true) <= 0.3 * true + 1e-6 * bn, (name, rep, true)
    print("all four solves converged; reported residuals are true residuals")


if __name__ == "__main__":
    main()
