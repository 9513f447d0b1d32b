"""Event logging / tracing / profiling.

Equivalent of the reference's PETSc event-log system
(``src/StateSet/StateSetBase.cpp:661-678``, ``FspSolverMultiSinks.cpp:283-301``
and ``ReduceComponentTiming`` at ``:467-516``): named phase timers with
call counts, plus per-ODE-step traces (model time, #equations, wall time;
reference ``OdeSolverBase.cpp:105-132``).

On a single host there is nothing to MPI-reduce; ``reduce()`` returns
(min, max, sum) per event for report parity with ``ReduceComponentTiming``.
``jax.profiler`` trace capture can be toggled for deep kernel-level
profiling.
"""
from __future__ import annotations

import csv
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax

# Canonical event names, mirroring the phases the reference registers.
EVT_SETUP = "Setup"
EVT_PARTITION = "StatePartitioning"
EVT_MATGEN = "MatrixGeneration"
EVT_ODESOLVE = "ODESolve"
EVT_RHS = "RHSEvaluation"
EVT_SCATTER = "SolutionScatter"
EVT_EXPLORE = "StateExploration"
EVT_TOTAL = "Solving"


@dataclass
class EventRecord:
    count: int = 0
    total_s: float = 0.0
    flops: float = 0.0


@dataclass
class StepTrace:
    """Per-accepted-step trace (reference FiniteProblemSolverPerfInfo,
    ``OdeSolverBase.cpp:105-132``): one row per accepted integrator step —
    model time at step end, step size, method detail (Krylov m / BDF order
    / RK stages), active equation count, and the epoch's host wall clock.

    Steps are recorded *on device* into a ring buffer carried through the
    jitted integrator loop (:class:`~..solvers.base.DeviceStepTrace`) and
    drained here once per epoch; per-step host wall time is not observable
    inside a fused XLA while-loop, so ``wall_time`` holds the epoch-end
    timestamp for each of that epoch's steps."""
    model_time: List[float] = field(default_factory=list)
    step_h: List[float] = field(default_factory=list)
    aux: List[int] = field(default_factory=list)
    n_eqs: List[int] = field(default_factory=list)
    wall_time: List[float] = field(default_factory=list)
    #: steps lost to ring-buffer overwrite (oldest-first), for honesty
    truncated: int = 0

    def record(self, t: float, n_eqs: int):
        """Record a single step observed host-side (epoch-granularity
        fallback when no device trace is available)."""
        self.model_time.append(float(t))
        self.step_h.append(float("nan"))
        self.aux.append(0)
        self.n_eqs.append(int(n_eqs))
        self.wall_time.append(time.perf_counter())

    def record_epoch(self, n_steps: int, trace, n_eqs: int):
        """Drain one epoch's device-recorded ring buffer (chronological;
        on overflow the oldest steps are dropped and counted in
        ``truncated``).  ``trace`` is either the device ring-buffer object
        or an already-fetched ``(t, h, aux)`` tuple — the driver batches
        the fetch with its other per-epoch reads to save round-trips."""
        if trace is None:
            return
        import numpy as np
        n_steps = int(n_steps)
        if n_steps <= 0:
            return
        if isinstance(trace, tuple):
            t_d, h_d, aux_d = trace
        else:
            t_d, h_d, aux_d = jax.device_get((trace.t, trace.h, trace.aux))
        t = np.asarray(t_d, dtype=float)
        h = np.asarray(h_d, dtype=float)
        aux = np.asarray(aux_d, dtype=int)
        cap = t.shape[0]
        if n_steps > cap:                  # ring wrapped
            start = n_steps % cap
            order = np.r_[start:cap, 0:start]
            t, h, aux = t[order], h[order], aux[order]
            self.truncated += n_steps - cap
            k = cap
        else:
            k = n_steps
        wall = time.perf_counter()
        self.model_time.extend(t[:k].tolist())
        self.step_h.extend(h[:k].tolist())
        self.aux.extend(aux[:k].tolist())
        self.n_eqs.extend([int(n_eqs)] * k)
        self.wall_time.extend([wall] * k)

    @property
    def n_steps(self) -> int:
        return len(self.model_time)


class EventLog:
    """Named wall-clock phase timers with nesting support."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: Dict[str, EventRecord] = {}

    @contextmanager
    def timed(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = self.events.setdefault(name, EventRecord())
            rec.count += 1
            rec.total_s += dt

    def add(self, name: str, seconds: float):
        rec = self.events.setdefault(name, EventRecord())
        rec.count += 1
        rec.total_s += seconds

    def add_count(self, name: str, count: int, seconds: float = 0.0,
                  flops: float = 0.0):
        """Accumulate an event whose occurrences happen inside a fused
        on-device loop (e.g. RHS evaluations): the count and FLOPs are
        exact (from the integrator's carried stats, the reference's
        PetscLogFlops analogue, FspMatrixBase.cpp:429-444); wall seconds
        are attributable only if the caller measured them."""
        if not self.enabled:
            return
        rec = self.events.setdefault(name, EventRecord())
        rec.count += int(count)
        rec.total_s += float(seconds)
        rec.flops += float(flops)

    def reduce(self):
        """(min, max, sum) of each event's wall time across
        ``jax.distributed`` processes — real ``ReduceComponentTiming``
        parity (reference ``FspSolverMultiSinks.cpp:467-516``, MPI
        min/max/sum).  Collective when multi-process: every process must
        call it with the same event-name set (SPMD discipline, the same
        contract the reference's MPI_Reduce has).  Single-process: all
        three entries equal the local time."""
        import numpy as np
        if jax.process_count() <= 1:
            return {k: (v.total_s, v.total_s, v.total_s)
                    for k, v in self.events.items()}
        from jax.experimental import multihost_utils
        names = sorted(self.events)
        local = np.asarray([self.events[k].total_s for k in names],
                           dtype=np.float64)
        all_t = np.asarray(multihost_utils.process_allgather(local))
        all_t = all_t.reshape(jax.process_count(), len(names))
        return {k: (float(all_t[:, i].min()), float(all_t[:, i].max()),
                    float(all_t[:, i].sum()))
                for i, k in enumerate(names)}

    def report(self) -> str:
        lines = [f"{'event':<24}{'count':>10}{'total_s':>14}{'gflops':>10}"]
        for name, rec in sorted(self.events.items()):
            lines.append(f"{name:<24}{rec.count:>10}{rec.total_s:>14.6f}"
                         f"{rec.flops / 1e9:>10.3f}")
        return "\n".join(lines)

    def dump_csv(self, path: str):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["event", "count", "total_s", "flops"])
            for name, rec in sorted(self.events.items()):
                w.writerow([name, rec.count, rec.total_s, rec.flops])


@contextmanager
def profiler_trace(logdir: Optional[str]):
    """Capture a jax profiler trace (TensorBoard format) around a block."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
