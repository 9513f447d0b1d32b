"""Integrator layer: common contracts.

Mirror of the reference ``OdeSolverBase`` (``src/OdeSolver/OdeSolverBase.h``):
an integrator advances ``dy/dt = A(t) y`` from t0 toward t_final, calling an
optional FSP stop-check after every accepted step, and reports one of the
status codes 0 (reached t_final) / 1 (FSP tolerance violated — caller must
expand the state space) / -1 (fatal).

Accelerator-first re-design: each backend compiles its **entire adaptive time loop**
into one XLA program (``lax.while_loop``) — step-size control, error
estimation, the stop-check, and the step-halving interpolation retry all run
on device with no host round-trips.  The host only sees the final
(y, t, status).  Dynamic dimensions (Krylov basis size, BDF order) are
carried as traced integers over padded static buffers.

Solver types mirror the reference enum ``ODESolverType {KRYLOV, CVODE,
PETSC, EPIC}`` (OdeSolverBase.h:39): KRYLOV -> adaptive Krylov expm;
CVODE -> adaptive BDF + matrix-free GMRES; PETSC -> adaptive explicit
Runge-Kutta (Dormand-Prince); EPIC has no backend in the reference (falls
through) and maps to KRYLOV here.
"""
from __future__ import annotations

import enum
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.vecops import FspVector

#: matvec(t, y: FspVector) -> FspVector
MatVec = Callable[[Any, FspVector], FspVector]
#: stop_check(t, y[, aux]) -> per-constraint error excess [n_constraints];
#: any entry > 0 means FSP stop.  The solver records the elementwise
#: running max over every evaluation (SolveResult.viol_excess), which is
#: how the reference accumulates its per-sink expansion flags
#: (``to_expand_``, FspSolverMultiSinks.cpp:576-611).  The optional third
#: argument is the ``stop_aux`` pytree passed to ``solve`` — per-epoch
#: stop-check data (e.g. already-forfeited sink mass) threaded as a jit
#: *argument* so epoch changes never recompile.
StopCheck = Callable[..., jnp.ndarray]


def wrap_stop_check(fn: Optional[StopCheck]) -> Optional[StopCheck]:
    """Normalize a stop-check to the 3-argument ``(t, y, aux)`` form."""
    if fn is None:
        return None
    import inspect
    try:
        n_params = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 3:
        return fn
    return lambda t, y, aux: fn(t, y)


class ODESolverType(enum.Enum):
    KRYLOV = "krylov"
    CVODE = "cvode"          # BDF + matrix-free GMRES
    PETSC = "petsc"          # adaptive explicit RK (Dormand-Prince 5(4))
    EPIC = "epic"            # alias of KRYLOV (reference: no backend)

    @classmethod
    def from_string(cls, s: str) -> "ODESolverType":
        s = s.strip().lower()
        for v in cls:
            if v.value == s or v.name.lower() == s:
                return v
        raise ValueError(f"unknown ODE solver type {s!r}")


class SolveStats(NamedTuple):
    n_steps: jnp.ndarray      # accepted steps
    n_rejected: jnp.ndarray
    n_matvecs: jnp.ndarray


class DeviceStepTrace(NamedTuple):
    """Per-accepted-step trace recorded *inside* the jitted while-loop
    (reference per-step perf logging, ``OdeSolverBase.cpp:105-132``) into a
    fixed-capacity ring buffer: entry ``i = step % capacity`` holds the
    step's end time, step size, and a method-specific integer (Krylov
    basis dimension m / BDF order / RK stage count).  When an epoch takes
    more than ``capacity`` steps the oldest entries are overwritten;
    chronological order is reconstructed host-side from the step count."""
    t: jnp.ndarray            # [cap] model time at step end
    h: jnp.ndarray            # [cap] accepted step size
    aux: jnp.ndarray          # [cap] int32 m / order / stages


def make_trace(cap: int, dtype) -> Optional[DeviceStepTrace]:
    if cap <= 0:
        return None
    return DeviceStepTrace(t=jnp.zeros((cap,), dtype),
                           h=jnp.zeros((cap,), dtype),
                           aux=jnp.zeros((cap,), jnp.int32))


def trace_record(tr: Optional[DeviceStepTrace], n_steps, accept, t, h, aux
                 ) -> Optional[DeviceStepTrace]:
    """Record one (possibly conditional) accepted step into the ring."""
    if tr is None:
        return None
    i = jnp.mod(n_steps, tr.t.shape[0])
    return DeviceStepTrace(
        t=tr.t.at[i].set(jnp.where(accept, t, tr.t[i])),
        h=tr.h.at[i].set(jnp.where(accept, h, tr.h[i])),
        aux=tr.aux.at[i].set(jnp.where(accept, jnp.asarray(aux, jnp.int32),
                                       tr.aux[i])))


class SolveResult(NamedTuple):
    y: FspVector
    t: jnp.ndarray
    status: jnp.ndarray       # 0 ok / 1 fsp stop / -1 failure
    stats: SolveStats
    viol_excess: jnp.ndarray  # [n_c] running max of stop-check excesses
    trace: Optional[DeviceStepTrace] = None


# Status codes (reference OdeSolverBase.h:114).  STATUS_CONTINUE is an
# addition with no reference analogue: one jitted solve call is one
# device DISPATCH, and a dispatch that runs for minutes leaves the host
# blind (no progress, no wedge detection).  Integrators therefore budget
# matvecs per dispatch and return STATUS_CONTINUE with a resumable
# (t, y); the driver loops.
STATUS_OK = 0
STATUS_FSP_STOP = 1
STATUS_FAILURE = -1
STATUS_CONTINUE = 2


def mv_per_dispatch_default() -> int:
    """CAP on the matvec budget per jitted integrator dispatch (0 =
    unbounded).  The FSP driver adapts the actual per-dispatch budget to
    the measured per-matvec wall (targeting ~20 s per dispatch); this
    cap bounds direct solver users and the adaptive controller alike."""
    import os
    return int(os.environ.get("PACMENSL_MV_PER_DISPATCH", "65536"))
