"""Smoke run of neptune-tpu on one NVIDIA GPU, or on four with --multichip.

Drives the main entry points at full width on seeded random data and checks
every result against an independent NumPy float64 reference on the host:

  poisson_mg_cg    solve_linear(cg, precond="mg", tol=1e-10) of the 2-D
                   5-point Dirichlet Poisson operator, 8192^2 float64
  imex_heat_step   the implicit heat step of `__graft_entry__._build_step`
                   (time_advance implicit_linear, CG), 8192^2 float32
  jfnk_allen_cahn  a fully implicit Allen-Cahn Euler step solved by
                   Newton-Krylov (solve_nonlinear), 4096^2 float64
  sweeps_heat3d    cm.sweeps of the 3-D 7-point heat operator, 8 sweeps,
                   512^3 float32
  single_apply     one apply of three operators timed against a same-size
                   device copy, plus plain CG's time per iteration at 512^2

--multichip runs only the four-card phase: the GSPMD implicit heat step,
shardmap_opdef, shardmap_sweeps (k=4) and cg_sharded at 8192^2 float64, and
the GSPMD apply of the 4th-order star at 8192^2 float32, over GridMesh((4,))
and GridMesh((2, 2)), each compared with the same call on one card in the
same process.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --multichip   # four GPUs of one host

Each phase prints one JSON line with its numbers, then asserts. The last line
is {"ok": true, "device": {...}}. Without a GPU the script exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# HBM bandwidth from NVIDIA's H100 SXM data sheet, for the roofline share
H100_HBM_BYTES_PER_S = 3.35e12


def _report(phase: str, rec: dict) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


def _alternating(fns: dict, x, calls: int, rounds: int = 5) -> dict:
    """Median seconds per call of each fn(x), timed in rounds of `calls`
    back-to-back calls, the order reversed every other round."""
    times = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(_timed(fns[k], x, reps=calls)[2])
    return {k: float(np.median(v)) for k, v in times.items()}


def _timed(fn, *args, reps: int = 1):
    """Seconds per call of fn(*args) after one warm-up (compile) call."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, compile_s, (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def _captured():
    """Collect the solvers' verbose convergence lines (jax.debug.print)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            yield buf
        finally:
            jax.effects_barrier()


def _solve_info(text: str) -> dict:
    m = re.findall(r"iters=(\d+) resnorm=(\S+) converged=(\w+)", text)
    if not m:
        raise AssertionError(f"no convergence report in {text!r}")
    iters, resnorm, conv = m[-1]
    return {"iters": int(iters), "reported_resnorm": float(resnorm),
            "converged": conv == "True"}


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# NumPy float64 references (independent of the library's lowering)
# ---------------------------------------------------------------------------


def np_lap(u):
    """sum of the 2*rank face neighbours - 2*rank*u, on the interior."""
    c = (slice(1, -1),) * u.ndim
    s = -2.0 * u.ndim * u[c]
    for d in range(u.ndim):
        for lo in (slice(0, -2), slice(2, None)):
            s = s + u[tuple(lo if e == d else slice(1, -1)
                            for e in range(u.ndim))]
    return s


def np_interior_op(u, f):
    """Copy-through apply: f(u) on the interior, u on the boundary ring."""
    out = np.array(u, np.float64)
    out[(slice(1, -1),) * u.ndim] = f(out)
    return out


def np_poisson(u):
    return np_interior_op(u, lambda v: -np_lap(v))


def np_heat(u, nu):
    """u + nu * lap(u) inside, u on the ring (nu < 0: the implicit system)."""
    c = (slice(1, -1),) * u.ndim
    return np_interior_op(u, lambda v: v[c] + nu * np_lap(v))


def np_adv4(u):
    v = np.asarray(u, np.float64)
    out = v.copy()
    c = (slice(2, -2), slice(2, -2))

    def at(i, j):
        n0, n1 = v.shape
        return v[2 + i:n0 - 2 + i, 2 + j:n1 - 2 + j]

    dudx = (-at(2, 0) + 8 * at(1, 0) - 8 * at(-1, 0) + at(-2, 0)) / 12.0
    dudy = (-at(0, 2) + 8 * at(0, 1) - 8 * at(0, -1) + at(0, -2)) / 12.0
    out[c] = v[c] - 0.1 * (0.7 * dudx + 0.3 * dudy)
    return out


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def poisson_mg_cg(n: int = 8192, seed: int = 0) -> dict:
    import neptune_tpu as ntp

    ntp.reset_context()

    @ntp.linear_op_def(bounds=([0, 0], [n, n]),
                       interior=([1, 1], [n - 1, n - 1]),
                       dtype="float64", name="poisson")
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    H = ntp.assemble_matrix(poisson)
    b = jax.random.normal(jax.random.key(seed), (n, n), jnp.float64)
    solve = jax.jit(lambda rhs: ntp.solve_linear(
        H, rhs, solver="cg", precond="mg", tol=1e-10, max_iters=5000,
        verbose=True))
    with _captured() as log:
        x, compile_s, solve_s = _timed(solve, b)
    info = _solve_info(log.getvalue())
    bh = np.asarray(b)
    res = _rel(np_poisson(np.asarray(x)), bh)
    rec = {"n": n, "dtype": "float64", **info, "compile_s": compile_s,
           "solve_s": solve_s, "true_rel_residual": res, "limit": 1e-9,
           "peak_bytes_in_use": _peak_bytes()}
    _report("poisson_mg_cg", rec)
    assert info["converged"], rec
    assert res <= 1e-9, rec
    return rec


def imex_heat_step(n: int = 8192, seed: int = 1) -> dict:
    from __graft_entry__ import _build_step

    cm = _build_step(n, "float32")
    step = jax.jit(cm.function("step"))
    u0 = jax.random.uniform(jax.random.key(seed), (n, n), jnp.float32)
    u1, compile_s, step_s = _timed(step, u0)
    u0h = np.asarray(u0, np.float64)
    # heat_A = u - 0.1 * lap(u) inside, identity on the ring. The solve's
    # own tolerance is 1e-6 on the float32 recursive residual; the limit
    # leaves a decade for float32 rounding of A*u1 and of the recursion.
    res = _rel(np_heat(np.asarray(u1, np.float64), -0.1), u0h)
    rec = {"n": n, "dtype": "float32", "compile_s": compile_s,
           "step_s": step_s, "true_rel_residual": res, "limit": 1e-5,
           "peak_bytes_in_use": _peak_bytes()}
    _report("imex_heat_step", rec)
    assert np.isfinite(res) and res <= 1e-5, rec
    return rec


def jfnk_allen_cahn(n: int = 4096, seed: int = 2) -> dict:
    """Implicit Euler step of u_t = eps^2 lap u + u - u^3 on [0,1]^2 with
    h = 1/n, an interface about four cells wide (eps = 4h) and dt = 0.1:
    the residual of `examples/allen_cahn.py:newton_step` in two dimensions."""
    import neptune_tpu as ntp

    ntp.reset_context()
    dxinv2, eps2, dt = float(n) ** 2, (4.0 / n) ** 2, 0.1
    xs = (np.arange(n) + 0.5) / n
    r = np.hypot(xs[:, None] - 0.5, xs[None, :] - 0.5)
    noise = 0.05 * np.random.default_rng(seed).standard_normal((n, n))
    u_prev_h = np.tanh((0.25 - r) / (np.sqrt(2.0 * eps2))) + noise
    u_prev_arr = jnp.asarray(u_prev_h)
    u_prev = ntp.temp(u_prev_arr)

    def residual(u):
        i, j = ntp.index(0), ntp.index(1)
        boundary = (i == 0) | (i == n - 1) | (j == 0) | (j == n - 1)
        lap = dxinv2 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1]
                        - 4.0 * u[0, 0])
        rhs = eps2 * lap + u[0, 0] - u[0, 0] * u[0, 0] * u[0, 0]
        interior = u[0, 0] - u_prev[0, 0] - dt * rhs
        return ntp.where(boundary, u[0, 0] - u_prev[0, 0], interior)

    t0 = time.perf_counter()
    with _captured() as log:
        u1 = jax.block_until_ready(ntp.solve_nonlinear(
            residual, u_prev_arr, tol=1e-10, max_iters=20, verbose=True))
    wall_s = time.perf_counter() - t0
    info = _solve_info(log.getvalue())

    def np_residual(u):
        f = u - u_prev_h
        c = (slice(1, -1), slice(1, -1))
        uc = u[c]
        f[c] = uc - u_prev_h[c] - dt * (eps2 * dxinv2 * np_lap(u)
                                        + uc - uc ** 3)
        return f

    f0 = np.linalg.norm(np_residual(u_prev_h))
    res = float(np.linalg.norm(np_residual(np.asarray(u1))) / f0)
    rec = {"n": n, "dtype": "float64", **info,
           "wall_s_with_compile": wall_s, "rel_nonlinear_residual": res,
           "limit": 1e-9, "peak_bytes_in_use": _peak_bytes()}
    _report("jfnk_allen_cahn", rec)
    assert info["converged"], rec
    assert res <= 1e-9, rec
    return rec


def _heat3d_op(n):
    import neptune_tpu as ntp

    @ntp.linear_op_def(bounds=([0, 0, 0], [n, n, n]),
                       interior=([1, 1, 1], [n - 1, n - 1, n - 1]),
                       dtype="float32", name="heat3d")
    def heat3d(u):
        return u[0, 0, 0] + 0.1 * (
            u[-1, 0, 0] + u[1, 0, 0] + u[0, -1, 0] + u[0, 1, 0]
            + u[0, 0, -1] + u[0, 0, 1] - 6.0 * u[0, 0, 0])

    return heat3d


def _adv4_op(n):
    """4th-order advection, f32: the reach-2 2-D star."""
    import neptune_tpu as ntp

    @ntp.nonlinear_op_def(bounds=([0, 0], [n, n]),
                          interior=([2, 2], [n - 2, n - 2]),
                          dtype="float32", name="adv4")
    def adv4(u):
        dudx = (-u[2, 0] + 8.0 * u[1, 0] - 8.0 * u[-1, 0] + u[-2, 0]) / 12.0
        dudy = (-u[0, 2] + 8.0 * u[0, 1] - 8.0 * u[0, -1] + u[0, -2]) / 12.0
        return u[0, 0] - 0.1 * (0.7 * dudx + 0.3 * dudy)

    return adv4


def sweeps_heat3d(n: int = 512, k: int = 8, seed: int = 3) -> dict:
    import neptune_tpu as ntp

    ntp.reset_context()
    _heat3d_op(n)
    cm = ntp.get_context().compiled()
    run = jax.jit(cm.sweeps("heat3d", k))
    x = jax.random.normal(jax.random.key(seed), (n, n, n), jnp.float32)
    y, compile_s, run_s = _timed(run, x, reps=3)
    want = np.asarray(x, np.float64)
    for _ in range(k):
        want = np_heat(want, 0.1)
    err = float(np.max(np.abs(np.asarray(y, np.float64) - want))
                / np.max(np.abs(want)))
    rec = {"n": n, "k": k, "dtype": "float32", "compile_s": compile_s,
           "run_s": run_s, "gcell_updates_per_s": n ** 3 * k / run_s / 1e9,
           "max_rel_err": err, "limit": 1e-5}
    _report("sweeps_heat3d", rec)
    assert err <= 1e-5, rec
    return rec


def single_apply(n2: int = 8192, n3: int = 512, n_cg: int = 512,
                 calls: int = 20, power_limit: str = "") -> dict:
    """One `cm.opdef` apply of three operators against a same-size device
    copy (-x: one read, one write); medians of alternating rounds in this
    call. Bytes per apply are one read and one write of the array, computed
    from its shape."""
    import neptune_tpu as ntp

    ntp.reset_context()

    @ntp.linear_op_def(bounds=([0, 0], [n2, n2]),
                       interior=([1, 1], [n2 - 1, n2 - 1]),
                       dtype="float32", name="lap5")
    def lap5(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    _adv4_op(n2)
    _heat3d_op(n3)
    cm = ntp.get_context().compiled()
    copy = jax.jit(lambda v: -v)
    cases = [("lap5", (n2, n2), np_poisson),
             ("adv4", (n2, n2), np_adv4),
             ("heat3d", (n3, n3, n3), lambda v: np_heat(v, 0.1))]
    rows = {}
    for i, (name, shape, oracle) in enumerate(cases):
        x = jax.random.normal(jax.random.key(10 + i), shape, jnp.float32)
        fns = {"apply": jax.jit(cm.opdef(name)), "copy": copy}
        y = np.asarray(fns["apply"](x), np.float64)
        err = float(np.max(np.abs(y - oracle(np.asarray(x, np.float64)))))
        med = _alternating(fns, x, calls)
        nbytes = 2 * x.size * x.dtype.itemsize
        row = {"shape": list(shape), "max_abs_err": err}
        for k, t in med.items():
            row[f"{k}_s"] = t
            row[f"{k}_gb_s"] = nbytes / t / 1e9
        row["apply_share_of_copy"] = med["copy"] / med["apply"]
        row["apply_share_of_3_35_tb_s"] = (
            nbytes / med["apply"] / H100_HBM_BYTES_PER_S)
        rows[name] = row
        assert err <= 1e-4, (name, row)

    # plain (unpreconditioned) CG on the 512^2 Poisson operator: per-
    # iteration time of the XLA while-loop, launch overheads included
    ntp.reset_context()

    @ntp.linear_op_def(bounds=([0, 0], [n_cg, n_cg]),
                       interior=([1, 1], [n_cg - 1, n_cg - 1]),
                       dtype="float32", name="poisson_cg")
    def poisson_cg(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    H = ntp.assemble_matrix(poisson_cg)
    b = jax.random.normal(jax.random.key(20), (n_cg, n_cg), jnp.float32)
    solve = jax.jit(lambda rhs: ntp.solve_linear(
        H, rhs, solver="cg", tol=1e-6, max_iters=2000, verbose=True))
    with _captured() as log:
        _, _, cg_s = _timed(solve, b)
    info = _solve_info(log.getvalue())
    rows["cg_plain"] = {"n": n_cg, "dtype": "float32", **info,
                        "solve_s": cg_s,
                        "s_per_iter": cg_s / max(info["iters"], 1)}
    rec = {"power_limit": power_limit, **rows}
    _report("single_apply", rec)
    return rec


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------


def multichip(n: int = 8192, devices=None, seed: int = 4) -> dict:
    """Each sharded path against the same call on one card. f64, except
    the GSPMD apply of the f32 4th-order star (reach 2, so its halos are
    two cells deep); the tolerances allow only for reordered sums and, in
    f32, for a different contraction of the body (the solves converge well
    past them: heat_A is I - 0.1*lap, condition number below 2)."""
    import neptune_tpu as ntp
    from __graft_entry__ import _build_step
    from neptune_tpu.parallel import (GridMesh, cg_sharded, shardmap_opdef,
                                      shardmap_sweeps, sharded_function,
                                      sharded_opdef)

    devs = list(devices if devices is not None else jax.devices()[:4])
    assert len(devs) == 4, devs
    cm = _build_step(n, "float64")
    ntp.reset_context()
    _adv4_op(n)
    cm_a = ntp.get_context().compiled()
    u0 = jax.device_put(
        jax.random.uniform(jax.random.key(seed), (n, n), jnp.float64), devs[0])
    v0 = jax.device_put(
        jax.random.normal(jax.random.key(seed + 1), (n, n), jnp.float32),
        devs[0])
    one = GridMesh((1,), ("x",), devices=devs[:1])
    paths = {
        "gspmd_heat_step": (
            lambda gm: sharded_function(cm, "step", gm),
            jax.jit(cm.function("step")), 1e-10, u0),
        "gspmd_adv4_f32": (
            lambda gm: sharded_opdef(cm_a, "adv4", gm),
            jax.jit(cm_a.opdef("adv4")), 1e-6, v0),
        "shardmap_opdef": (
            lambda gm: jax.jit(shardmap_opdef(cm, "heat_A", gm)),
            jax.jit(cm.opdef("heat_A")), 1e-13, u0),
        "shardmap_sweeps_k4": (
            lambda gm: jax.jit(shardmap_sweeps(cm, "heat_A", gm, 4)),
            jax.jit(cm.sweeps("heat_A", 4)), 1e-13, u0),
        "cg_sharded_s4": (
            lambda gm: jax.jit(cg_sharded(cm, "heat_A", gm, s=4, tol=1e-12,
                                          maxiter=200)),
            jax.jit(cg_sharded(cm, "heat_A", one, s=4, tol=1e-12,
                               maxiter=200)), 1e-10, u0),
    }
    rows = {}
    for mesh_shape, names in (((4,), ("x",)), ((2, 2), ("x", "y"))):
        gm = GridMesh(mesh_shape, names, devices=devs)
        for path, (build, ref_fn, tol, x0) in paths.items():
            xs = gm.shard(x0)
            assert len(xs.sharding.device_set) == 4, xs.sharding
            got, _, t4 = _timed(build(gm), xs)
            want, _, t1 = _timed(ref_fn, x0)
            if isinstance(got, tuple):  # (x, SolveInfo) from cg_sharded
                assert bool(got[1].converged) and bool(want[1].converged)
                got, want = got[0], want[0]
            n_dev = len(got.sharding.device_set)
            diff = _rel(np.asarray(got), np.asarray(want))
            key = f"{path}@{'x'.join(map(str, mesh_shape))}"
            rows[key] = {"rel_diff": diff, "limit": tol, "devices": n_dev,
                         "s_4_cards": t4, "s_1_card": t1}
            print(json.dumps({key: rows[key]}), file=sys.stderr, flush=True)
            assert n_dev == 4 and diff <= tol, (key, rows[key])
    rec = {"n": n, **rows}
    _report("multichip", rec)
    return rec


# ---------------------------------------------------------------------------


def _card() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    need = 4 if args.multichip else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1

    jax.config.update("jax_enable_x64", True)
    from neptune_tpu.config import setup_persistent_cache

    cache = setup_persistent_cache()
    card = _card()
    print(card, flush=True)
    print(json.dumps({"device_kind": devs[0].device_kind,
                      "jax": jax.__version__, "compile_cache": cache}),
          flush=True)
    if args.multichip:
        multichip(devices=devs[:need])
    else:
        poisson_mg_cg()
        imex_heat_step()
        jfnk_allen_cahn()
        sweeps_heat3d()
        single_apply(power_limit=card.split(",")[-1].strip())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
