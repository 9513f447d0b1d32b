"""Smoke check: the FSP solve -> check-sinks -> expand loop on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py            # phases (a)-(e) on one card
    python chip_smoke.py --multi    # only the sharded path, on four cards

Phases (one card):

(a) device: refuses anything but JAX's GPU backend; prints the card's
    name and power limit, the jax/jaxlib versions, the compile-cache
    directory and whether the native state directory loaded.
(b) operators against the CSR reference (pacmensl_tpu/ops/reference.py)
    in float64 and float32: the box action on the fixed 128^3
    hyper-rectangle, and the ELL action on the repressilator's custom
    constraint set at the bounds its t=10 solve reached.
(c) the main path: the repressilator benchmark deployment
    (examples/repressilator.cpp:131-133,162-165; t_final=10,
    fsp_tol=1e-4) through FspSolverMultiSinks with default options, twice
    in one process (cold, then warm).
(d) analytic oracles: Poisson(2t) with the Krylov and BDF integrators,
    the birth-death stationary law, the poisson_sens derivative.
(e) a box-backend solve (repressilator hyper-rectangle bounds) and a
    time-varying BDF solve (hog1p_5d).

Any failed check exits non-zero.  The last line of stdout is one JSON
object ``{"ok": true, "device": {...}}``; it is printed only when every
phase passed.  JAX_PLATFORMS is left alone: the CPU backend stays
available beside CUDA for host-side assembly.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

F64_TOL = 1e-12
# float32: inflow and outflow terms cancel at eps ~ 6e-8
F32_TOL = 1e-5


class SmokeFailure(Exception):
    pass


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def _repressilator_solver(bundle, bounds=None, factors=None, mesh=None,
                          partitioning=None):
    import pacmensl_tpu as pm
    kw = {} if mesh is None else {"mesh": mesh}
    if partitioning is not None:
        kw["partitioning"] = partitioning
    s = pm.FspSolverMultiSinks(**kw)
    s.set_model(bundle.model)
    if bounds is None:
        s.set_constraints(bundle.constraint, bundle.bounds,
                          bundle.expansion_factors)
    else:
        s.set_initial_bounds(bounds)
        s.set_expansion_factors(factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    return s


# ---------------------------------------------------------------- (a)
def phase_device() -> dict:
    import jax
    import jaxlib
    from pacmensl_tpu.native import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"card: {smi.stdout.strip()}")
    log(f"jax {jax.__version__}  jaxlib {jaxlib.__version__}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    lib = build.load()
    log("native fastset: " + ("loaded" if lib is not None
                              else f"not loaded ({build.load_error()})"))
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------- (b)
def phase_box_operator(bound: int = 127, seed: int = 0) -> None:
    import numpy as np
    import jax.numpy as jnp
    from pacmensl_tpu.ops.box_operator import BoxOperator
    from pacmensl_tpu.ops.reference import box_action_error, box_space_fixed
    b, space = box_space_fixed(bound)
    p = np.random.default_rng(seed).random(space.shape) * space.mask_host
    p /= p.sum()
    ref = None
    for dtype, tol in ((jnp.float64, F64_TOL), (jnp.float32, F32_TOL)):
        op = BoxOperator(b.model, space, dtype=dtype)
        t0 = time.perf_counter()
        e_dp, e_s, off, ref = box_action_error(op, 0.0, p, ref=ref)
        log(f"box {space.shape} {dtype.__name__}: n={space.num_states} "
            f"nnz={ref.nnz} rel_l1 dp={e_dp:.3e} sinks={e_s:.3e} "
            f"[{time.perf_counter() - t0:.1f}s]")
        check(e_dp <= tol and e_s <= tol and off == 0.0,
              f"box action {dtype.__name__} within {tol:g} of the CSR "
              "reference")


def phase_ell_operator(solver, seed: int = 0) -> None:
    """The ELL operator the main-path solve ended on, and its float32
    twin, against the CSR reference of the same state set."""
    import numpy as np
    import jax.numpy as jnp
    from pacmensl_tpu.ops.ell_operator import EllOperator
    from pacmensl_tpu.ops.reference import ell_action_error
    op64 = solver._operator
    ss = op64.state_set
    p = np.zeros(op64.n_pad)
    p[:ss.num_states] = np.random.default_rng(seed).random(ss.num_states)
    p /= p.sum()
    ref = None
    for dtype, tol in ((jnp.float64, F64_TOL), (jnp.float32, F32_TOL)):
        op = op64 if dtype == jnp.float64 else EllOperator(
            op64.model, ss, dtype=dtype)
        e_dp, e_s, tail, ref = ell_action_error(op, 0.0, p, ref=ref)
        log(f"ell {dtype.__name__}: n={ss.num_states} nnz={ref.nnz} "
            f"gather={op._gather_mode()} rel_l1 dp={e_dp:.3e} "
            f"sinks={e_s:.3e}")
        check(e_dp <= tol and e_s <= tol and tail == 0.0,
              f"ELL action {dtype.__name__} within {tol:g} of the CSR "
              "reference")


# ---------------------------------------------------------------- (c)
def phase_main_solve(t_final: float = 10.0, fsp_tol: float = 1e-4,
                     runs: int = 2):
    import numpy as np
    import pacmensl_tpu as pm
    b = pm.models.repressilator()
    walls = []
    for i in range(runs):
        s = _repressilator_solver(b)
        t0 = time.perf_counter()
        d = s.solve(t_final, fsp_tol)
        walls.append(time.perf_counter() - t0)
        tag = "cold" if i == 0 else "warm"
        log(f"repressilator t={t_final} ({tag}): wall {walls[-1]:.2f}s "
            f"n_states={d.num_states} bounds={d.bounds.tolist()} "
            f"mass={d.sum():.8f} sinks={np.asarray(d.sinks).tolist()}")
        log(f"  backend={s._backend_used} "
            f"gather={getattr(s._operator, '_gather_mode', lambda: '-')()}")
        log(s.get_event_log().report())
        check(1.0 - d.sum() <= fsp_tol,
              f"repressilator ({tag}) 1 - sum(p) <= {fsp_tol:g}")
    return s, d, walls


# ---------------------------------------------------------------- (d)
def phase_oracles(t_final: float = 10.0, fsp_tol: float = 1e-4) -> None:
    import numpy as np
    from scipy.stats import poisson as law
    import pacmensl_tpu as pm
    b = pm.models.poisson(2.0)
    for ode in ("krylov", "cvode"):
        s = pm.FspSolverMultiSinks(odes_type=ode)
        s.set_model(b.model)
        # wide first bounds: a few expansion epochs, few compiles
        s.set_initial_bounds([20])
        s.set_expansion_factors([0.5])
        s.set_initial_distribution(b.x0, b.p0)
        d = s.solve(t_final, fsp_tol)
        err = float(np.abs(d.p - law.pmf(d.states[:, 0],
                                         2.0 * t_final)).sum())
        log(f"poisson {ode}: n={d.num_states} l1={err:.3e}")
        check(err <= fsp_tol, f"Poisson({2.0 * t_final:g}) {ode} l1 <= "
              f"{fsp_tol:g}")

    bd = pm.models.birth_death(birth=1.0, death=0.1)
    s = pm.StationaryFspSolverMultiSinks()
    s.set_model(bd.model)
    s.set_initial_bounds([10])
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(bd.x0, bd.p0)
    d = s.solve(1.0e-7)
    pdf = law.pmf(d.states[:, 0], 10.0)
    err = float(np.abs(d.p - pdf / pdf.sum()).sum())
    log(f"birth-death stationary: n={d.num_states} l1={err:.3e}")
    check(err < 1e-6, "birth-death stationary law is Poisson(10)")

    from scipy.special import gammaln
    ps = pm.models.poisson_sens(2.0)
    s = pm.SensFspSolverMultiSinks()
    s.set_model(ps.model)
    s.set_initial_bounds([5])
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(ps.x0, ps.p0)
    s.set_ode_tolerances(1e-8, 1e-14)
    t_s, tol_s = 1.0, 1.0e-7
    d = s.solve(t_s, tol_s)
    nn = d.states[:, 0].astype(np.float64)
    pdf = np.exp(-2.0 * t_s + nn * np.log(2.0 * t_s) - gammaln(nn + 1))
    sens = -t_s * pdf + t_s * np.concatenate([[0.0], pdf[:-1]])
    err_p = float(np.abs(d.p - pdf).sum())
    err_s = float(np.abs(d.dp[0] - sens).sum())
    log(f"poisson_sens: l1 p={err_p:.3e} dp/dlambda={err_s:.3e}")
    check(err_p <= tol_s and err_s <= 1e-6,
          "poisson_sens p and dp/dlambda match the analytic law")


# ---------------------------------------------------------------- (e)
def phase_box_solve(t_final: float = 10.0, fsp_tol: float = 1e-4) -> None:
    import pacmensl_tpu as pm
    b = pm.models.repressilator()
    s = _repressilator_solver(b, bounds=b.bounds_hyperrec,
                              factors=b.expansion_factors_hyperrec)
    t0 = time.perf_counter()
    d = s.solve(t_final, fsp_tol)
    log(f"repressilator hyper-rectangle t={t_final}: wall "
        f"{time.perf_counter() - t0:.2f}s backend={s._backend_used} "
        f"capacity={tuple(s._space.shape)} n_states={d.num_states} "
        f"bounds={d.bounds.tolist()} mass={d.sum():.8f}")
    check(s._backend_used == "box", "hyper-rectangle solve ran on the box "
          "backend")
    check(1.0 - d.sum() <= fsp_tol, f"box solve 1 - sum(p) <= {fsp_tol:g}")


def phase_hog1p(t_final: float = 45.0, fsp_tol: float = 1e-4) -> None:
    """hog1p_5d to t=45 (the upstream runs to t=180, examples/hog1p.cpp:
    150-158; cut so the whole smoke stays well inside its time limit)."""
    import pacmensl_tpu as pm
    b = pm.models.hog1p_5d()
    s = pm.FspSolverMultiSinks(odes_type="cvode")
    s.set_model(b.model)
    s.set_constraints(b.constraint, b.bounds, b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    t0 = time.perf_counter()
    d = s.solve(t_final, fsp_tol)
    log(f"hog1p_5d BDF t={t_final}: wall {time.perf_counter() - t0:.2f}s "
        f"backend={s._backend_used} n_states={d.num_states} "
        f"bounds={d.bounds.tolist()} mass={d.sum():.8f}")
    log(s.get_event_log().report())
    check(1.0 - d.sum() <= fsp_tol, f"hog1p_5d 1 - sum(p) <= {fsp_tol:g}")


# ------------------------------------------------------------- --multi
def phase_multi(n_devices: int = 4, bound: int = 127,
                t_final: float = 10.0, fsp_tol: float = 1e-4) -> None:
    """The 128^3 box action sharded over the mesh (GSPMD) against the
    one-card action, and the repressilator solve on the mesh with GRAPH
    partitioning (ShardedEllOperator's all_to_all) against the one-card
    solve.  The sharded solve runs first, and both print every expansion
    epoch, so a stalled collective shows as a stopped epoch log."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import pacmensl_tpu as pm
    from pacmensl_tpu.ops.box_operator import BoxOperator
    from pacmensl_tpu.ops.reference import box_space_fixed, rel_l1
    from pacmensl_tpu.ops.vecops import FspVector
    from pacmensl_tpu.parallel.mesh import make_mesh, shard_fsp_vector
    mesh = make_mesh(n_devices)
    b, space = box_space_fixed(bound)
    op = BoxOperator(b.model, space, dtype=jnp.float64)
    p = np.random.default_rng(0).random(space.shape) * space.mask_host
    y1 = FspVector(p=jnp.asarray(p / p.sum()),
                   sinks=jnp.zeros((space.num_constraints,), jnp.float64))
    yn = shard_fsp_vector(y1, mesh)
    act = jax.jit(op.action)
    d1 = jax.device_get(act(0.0, y1, op.data()))
    dn = jax.device_get(act(0.0, yn, op.data()))
    e_dp, e_s = rel_l1(dn.p, d1.p), rel_l1(dn.sinks, d1.sinks)
    log(f"box {space.shape} on {n_devices} devices: rel_l1 dp={e_dp:.3e} "
        f"sinks={e_s:.3e}")
    check(e_dp <= F64_TOL and e_s <= F64_TOL,
          f"sharded box action within {F64_TOL:g} of one device")

    rep = pm.models.repressilator()
    dists = {}
    for tag, kw in ((f"{n_devices} devices", {"mesh": mesh,
                                              "partitioning": "graph"}),
                    ("1 device", {})):
        s = _repressilator_solver(rep, **kw)
        s.set_verbosity(1)
        log(f"repressilator t={t_final} on {tag}:")
        t0 = time.perf_counter()
        d = s.solve(t_final, fsp_tol)
        dists[tag] = d
        log(f"repressilator t={t_final} on {tag}: wall "
            f"{time.perf_counter() - t0:.2f}s n_states={d.num_states} "
            f"bounds={d.bounds.tolist()} mass={d.sum():.8f} "
            f"operator={type(s._operator).__name__}")
        log(s.get_event_log().report())
    mn, m1 = (d.sum() for d in dists.values())
    check(abs(m1 - mn) <= fsp_tol and 1.0 - mn <= fsp_tol,
          f"sharded solve mass within {fsp_tol:g} of one device")
    for dev in jax.devices()[:n_devices]:
        st = dev.memory_stats() or {}
        log(f"{dev}: bytes_in_use={st.get('bytes_in_use')} "
            f"peak_bytes_in_use={st.get('peak_bytes_in_use')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path, on four cards")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX's default backend is "
              f"{jax.default_backend()!r}, not 'gpu'; nothing was run",
              file=sys.stderr)
        return 2
    n_need = 4 if args.multi else 1
    if len(jax.devices()) < n_need:
        print(f"chip_smoke: need {n_need} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    timings = {}

    def run(name, fn, *a, **kw):
        log(f"=== {name}")
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        timings[name] = time.perf_counter() - t0
        log(f"=== {name}: {timings[name]:.2f}s")
        return out

    device = run("a device", phase_device)
    if args.multi:
        run("multi", phase_multi, n_devices=4)
    else:
        run("b box operator", phase_box_operator)
        solver, _, walls = run("c main-path solve", phase_main_solve)
        log(f"main-path solve cold {walls[0]:.2f}s warm {walls[1]:.2f}s")
        run("b ELL operator", phase_ell_operator, solver)
        run("d oracles", phase_oracles)
        run("e box-backend solve", phase_box_solve)
        run("e hog1p_5d BDF solve", phase_hog1p)
    log("phase walls: " + json.dumps(
        {k: round(v, 2) for k, v in timings.items()}))
    log(f"total {time.perf_counter() - t_all:.2f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    # one line at a time, so a run cut by its time limit keeps its log
    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(main())
