"""Communication-avoiding sharded relaxation: K Jacobi sweeps per halo
exchange via `shardmap_sweeps` — 1/K the messages and collective latency of
the exchange-every-sweep loop, with identical results (the K-deep-ghost
trapezoid scheme; see docs/PERFORMANCE.md "Sharded execution").

The reference has no distributed execution at all (SURVEY.md §2.8); this is
the scaling pattern its PETSc-on-one-process design cannot express.

Run (one GPU works; to simulate 8 devices on CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/comm_avoiding_jacobi.py --cpu
"""

import sys

import numpy as np

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax
import jax.numpy as jnp

import neptune_tpu as ntp
from neptune_tpu.parallel import GridMesh, shardmap_opdef, shardmap_sweeps

N = 128
K = 8  # sweeps per halo exchange
ROUNDS = 12  # exchanges (K * ROUNDS total sweeps)


# damped-Jacobi relaxation step for the Dirichlet Poisson problem
# u <- u + (omega/4) * (b - A u), written as a unary operator on u with the
# right-hand side folded in as zero (homogeneous problem: decay of a mode)
@ntp.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]))
def jacobi_sweep(u):
    return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])


def main():
    n_dev = len(jax.devices())
    a = next(c for c in range(int(n_dev**0.5), 0, -1) if n_dev % c == 0)
    gm = GridMesh((n_dev // a, a), ("x", "y"))
    print(f"devices: {n_dev}, mesh {gm.shape}")

    cm = ntp.get_context().compiled()

    # initial state: the (1,1) Dirichlet eigenmode, which plain Jacobi damps
    # by exactly lam = cos(pi/ (N-1))... per sweep on the interior
    ii = np.arange(N)
    mode = np.sin(np.pi * ii[:, None] / (N - 1)) * np.sin(
        np.pi * ii[None, :] / (N - 1)
    )
    mode[0, :] = mode[-1, :] = mode[:, 0] = mode[:, -1] = 0.0
    u0 = gm.shard(jnp.asarray(mode))

    # exchange-every-sweep loop
    mv = shardmap_opdef(cm, "jacobi_sweep", gm)

    @jax.jit
    def run_naive(u):
        return jax.lax.fori_loop(0, K * ROUNDS, lambda i, v: mv(v), u)

    # communication-avoiding: one exchange per K sweeps
    fk = shardmap_sweeps(cm, "jacobi_sweep", gm, K)

    @jax.jit
    def run_ca(u):
        return jax.lax.fori_loop(0, ROUNDS, lambda i, v: fk(v), u)

    naive = np.asarray(run_naive(u0))
    ca = np.asarray(run_ca(u0))
    dev = np.abs(naive - ca).max()
    print(f"max |naive - comm-avoiding| after {K * ROUNDS} sweeps: {dev:.3e}")
    assert dev < 1e-10 if naive.dtype == np.float64 else dev < 1e-4

    # analytic decay of the fundamental mode under plain Jacobi
    lam = 0.5 * (np.cos(np.pi / (N - 1)) + np.cos(np.pi / (N - 1)))
    predicted = lam ** (K * ROUNDS)
    measured = np.abs(ca[1:-1, 1:-1]).max() / np.abs(mode[1:-1, 1:-1]).max()
    print(f"mode decay: measured {measured:.6f}, analytic {predicted:.6f}")
    assert abs(measured - predicted) < 5e-3

    # ---- the same trapezoid carrying a whole SOLVER: CA-Chebyshev ----
    # K full (x, r, d) Chebyshev iterations per exchange, one psum at the end
    from neptune_tpu.parallel import chebyshev_sharded

    @ntp.linear_op_def(
        bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]),
        name="poisson_ca",
    )
    def poisson_ca(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    cm2 = ntp.get_context().compiled()
    lmin = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (N + 1)))
    b = np.zeros((N, N))
    b[1:-1, 1:-1] = np.random.default_rng(3).standard_normal((N - 2, N - 2))
    solve = jax.jit(
        chebyshev_sharded(
            cm2, "poisson_ca", gm, lam_min=lmin, lam_max=8.0,
            k_fuse=K, maxiter=4000, tol=1e-8,
        )
    )
    xs, info = solve(gm.shard(jnp.asarray(b)))
    xs = np.asarray(xs)
    f64 = xs.dtype == np.float64
    r = b.copy()
    r[1:-1, 1:-1] -= (
        4 * xs[1:-1, 1:-1] - xs[:-2, 1:-1] - xs[2:, 1:-1]
        - xs[1:-1, :-2] - xs[1:-1, 2:]
    )
    r[0, :] -= xs[0, :]
    r[-1, :] -= xs[-1, :]
    r[1:-1, 0] -= xs[1:-1, 0]
    r[1:-1, -1] -= xs[1:-1, -1]
    rel = np.linalg.norm(r) / np.linalg.norm(b)
    print(
        f"CA-Chebyshev solve: converged={bool(info.converged)} "
        f"({int(info.iters)} iterations, {K} per exchange), "
        f"true relative residual {rel:.2e}"
    )
    # f32 stalls at ~eps*kappa for this conditioning
    assert rel < (1e-6 if f64 else 1e-2)
    print("ok")


if __name__ == "__main__":
    main()
