"""Multi-chip Poisson solve: a 2-D field sharded over a device mesh with
automatic halo exchange, solved by distributed matrix-free CG — the
capability the single-process reference lacks entirely (SURVEY.md §2.8).

Run (one GPU works; to simulate 8 devices on CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/multichip_poisson.py --cpu
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
from neptune_tpu.parallel import GridMesh, sharded_opdef
from neptune_tpu.solvers import cg

N = 256


@ntp.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]))
def poisson(u):
    return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]


def main():
    n_dev = len(jax.devices())
    # factor the device count into a 2-D mesh
    a = next(c for c in range(int(n_dev**0.5), 0, -1) if n_dev % c == 0)
    gm = GridMesh((n_dev // a, a), ("x", "y"))
    print(f"devices: {n_dev}, mesh {gm.shape}")

    cm = ntp.get_context().compiled()
    matvec = cm.opdef("poisson")

    rng = np.random.default_rng(0)
    b = rng.standard_normal((N, N))
    b_sharded = gm.shard(jnp.asarray(b))

    @jax.jit
    def solve(b):
        x, info = cg(matvec, b, tol=1e-10, maxiter=3000)
        return x, info

    x, info = solve(b_sharded)
    x = np.asarray(x)
    print(f"CG iters={int(info.iters)} resnorm={float(info.resnorm):.3e} "
          f"converged={bool(info.converged)}")

    # the explicit-communication mode: per-shard execution with ppermute
    # ghost exchange at the operator's verified stencil reach
    from neptune_tpu.parallel import shardmap_opdef

    mv_explicit = jax.jit(shardmap_opdef(cm, "poisson", gm))
    y1 = np.asarray(mv_explicit(gm.shard(jnp.asarray(x))))
    y2 = np.asarray(matvec(jnp.asarray(x)))
    print(f"explicit shard_map matvec max dev: {np.abs(y1 - y2).max():.2e}")

    # residual check against the (replicated) numpy oracle
    r = b.copy()
    r[1:-1, 1:-1] -= (
        4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1] - x[1:-1, :-2] - x[1:-1, 2:]
    )
    r[0, :] -= x[0, :]
    r[-1, :] -= x[-1, :]
    r[1:-1, 0] -= x[1:-1, 0]
    r[1:-1, -1] -= x[1:-1, -1]
    print(f"max |A x - b| = {np.abs(r).max():.3e}")


if __name__ == "__main__":
    main()
