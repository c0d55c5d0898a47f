"""3-D heat diffusion, explicit stepping — the rank-3 stencil family.

    u_t = kappa Lap3(u),  u = 0 on the box boundary

Forward Euler on the 7-point Laplacian (BASELINE config #2's operator).
Validated against
the analytic separable mode

    u(x,y,z,t) = sin(pi x) sin(pi y) sin(pi z) exp(-3 kappa pi^2 t)

whose discrete counterpart decays with the 7-pt eigenvalue
lambda_h = (6 - 2(cos(pi h_x)+cos(pi h_y)+cos(pi h_z)))/h^2 — the check is
against the exact DISCRETE decay factor, so the error budget is pure
round-off plus time-stepping, not space discretization.

Run:  python examples/heat3d_explicit.py [--cpu]
"""

import sys

import numpy as np

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import neptune_tpu as ntp
from neptune_tpu.solvers import simulate

N = 64
KAPPA = 1.0
H = 1.0 / (N - 1)
DT = 0.15 * H * H / KAPPA  # forward-Euler stability needs dt <= h^2/6
STEPS = 400
DTYPE = "float64" if "--cpu" in sys.argv else "float32"


@ntp.linear_op_def(
    bounds=([0, 0, 0], [N, N, N]),
    interior=([1, 1, 1], [N - 1, N - 1, N - 1]),
    dtype=DTYPE,
    name="lap3",
)
def lap3(u):
    return (
        u[-1, 0, 0] + u[1, 0, 0] + u[0, -1, 0]
        + u[0, 1, 0] + u[0, 0, -1] + u[0, 0, 1]
        - 6.0 * u[0, 0, 0]
    ) / (H * H)


def main():
    xs = np.linspace(0.0, 1.0, N)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    mode = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    u0 = mode.astype(DTYPE)

    ring = np.zeros((N, N, N), bool)
    for d in range(3):
        sl = [slice(None)] * 3
        sl[d] = 0
        ring[tuple(sl)] = True
        sl[d] = -1
        ring[tuple(sl)] = True
    interior = jnp.asarray(~ring)

    def step(u):
        # lap3 is copy-through on the boundary ring; masking the update
        # keeps the homogeneous Dirichlet condition exact
        return jnp.where(interior, u + DT * KAPPA * lap3(u), 0.0)

    u = np.asarray(simulate(step, jnp.asarray(u0), STEPS), np.float64)

    # exact discrete decay: one step multiplies the mode by (1 - dt*k*lam_h)
    lam_h = (6.0 - 6.0 * np.cos(np.pi * H)) / (H * H)
    decay = (1.0 - DT * KAPPA * lam_h) ** STEPS
    u_exact = mode * decay
    err = np.abs(u - u_exact).max()
    tol = 1e-10 if DTYPE == "float64" else 1e-4
    print(f"N={N}^3 dt={DT:.2e} steps={STEPS} discrete decay={decay:.6f}")
    print(f"max |u - exact discrete mode| = {err:.3e}")
    assert err < tol, "diverged from the discrete eigenmode decay"
    print("OK: matches the 7-pt eigenmode decay exactly")


if __name__ == "__main__":
    main()
