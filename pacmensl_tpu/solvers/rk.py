"""Adaptive explicit Runge-Kutta integrator (TsFsp parity).

Replaces the reference's PETSc TS adapter (``src/OdeSolver/TsFsp.cpp``):
the default explicit path (TS type "rk") becomes a Dormand-Prince 5(4)
pair with a PI step-size controller, compiled into a single on-device
``lax.while_loop``.

FSP stop handling mirrors TsFsp's post-evaluate retry
(``TsFsp.cpp:128-198``): when an accepted step violates the FSP tolerance,
the step is retried from the previous state with half the step size, up to
10 trials, then the solver returns status 1 at a time where the check
passes (the reference interpolates with TSInterpolate; re-stepping with a
smaller h is equivalent for an explicit one-step method and needs no dense
output).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import DEFAULT_DTYPE
from ..ops import vecops as vo
from .base import (wrap_stop_check, make_trace, trace_record,
                   MatVec, StopCheck, SolveResult, SolveStats,
                   STATUS_OK, STATUS_FSP_STOP, STATUS_FAILURE)

# Dormand-Prince 5(4) tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
])
_B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84])
# embedded 4th-order weights
_B4 = np.array([5179 / 57600, 0, 7571 / 16695, 393 / 640,
                -92097 / 339200, 187 / 2100, 1 / 40])


class RKSolver:
    """Dormand-Prince 5(4) with PI controller over FspVectors."""

    _err_exp = -0.2          # -1/(embedded order + 1) = -1/5

    def __init__(self,
                 matvec: MatVec,
                 *,
                 rtol: Optional[float] = None,
                 atol: float = 1.0e-14,
                 safety: float = 0.9,
                 max_steps: int = 10_000_000,
                 stop_check: Optional[StopCheck] = None,
                 trace_cap: int = 4096,
                 dtype=None):
        self.matvec = matvec
        self.dtype = dtype or DEFAULT_DTYPE
        # f32 cannot resolve relative errors below ~1e-7 (see KrylovSolver)
        f32 = jnp.finfo(self.dtype).eps > 1.0e-10
        self.rtol = float(rtol if rtol is not None
                          else (1.0e-4 if f32 else 1.0e-6))
        self.atol = float(atol)
        self.safety = float(safety)
        self.max_steps = int(max_steps)
        self.trace_cap = int(trace_cap)
        self.stop_check = wrap_stop_check(stop_check)
        self._solve_jit = jax.jit(self._solve)

    def solve(self, y0, t0, t_final, data=None, stop_aux=None,
              mv_budget=None) -> SolveResult:
        """``data``: optional pytree forwarded to ``matvec(t, y, data)``
        so compiled programs stay valid across FSP expansion epochs;
        ``stop_aux`` likewise for the stop-check.  ``mv_budget`` is
        accepted for driver-interface parity and ignored (the explicit
        RK backends are cross-check integrators, not the production path
        for long dispatches)."""
        return self._solve_jit(y0, jnp.asarray(t0, self.dtype),
                               jnp.asarray(t_final, self.dtype), data,
                               stop_aux)

    def _mv(self, data):
        if data is None:
            return self.matvec
        return lambda t, y: self.matvec(t, y, data)

    # ------------------------------------------------------------------
    def _err_norm(self, err, y0, y1):
        """CVODE/scipy-style weighted RMS norm."""
        def leaf(e, a, b):
            scale = self.atol + self.rtol * jnp.maximum(jnp.abs(a),
                                                        jnp.abs(b))
            return jnp.sum((e / scale) ** 2), e.size
        leaves = zip(jax.tree_util.tree_leaves(err),
                     jax.tree_util.tree_leaves(y0),
                     jax.tree_util.tree_leaves(y1))
        tot, n = 0.0, 0
        for e, a, b in leaves:
            s, sz = leaf(e, a, b)
            tot = tot + s
            n += sz
        return jnp.sqrt(tot / n)

    def _rk_step(self, mv, t, y, h):
        """One DP5(4) step: returns (y5, err_vec, k1_next, n_mv)."""
        ks = []
        for i in range(6):
            yi = y
            for j in range(i):
                if _A[i, j] != 0.0:
                    yi = vo.axpy(h * _A[i, j], ks[j], yi)
            ks.append(mv(t + _C[i] * h, yi))
        y5 = y
        for i in range(6):
            if _B[i] != 0.0:
                y5 = vo.axpy(h * _B[i], ks[i], y5)
        k7 = mv(t + h, y5)          # FSAL stage
        ks.append(k7)
        # error = y5 - y4
        err = vo.zeros_like(y)
        for i in range(7):
            d = _B[i] - _B4[i] if i < 6 else -_B4[6]
            if d != 0.0:
                err = vo.axpy(h * d, ks[i], err)
        return y5, err, 7

    def _initial_step(self, mv, t0, y0, t_final):
        """scipy-style initial step heuristic (order 5)."""
        f0 = mv(t0, y0)
        scale_dot = self._err_norm(y0, y0, y0)  # ||y/scale||
        d0 = scale_dot
        d1 = self._err_norm(f0, y0, y0)
        h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
        y1 = vo.axpy(h0, f0, y0)
        f1 = mv(t0 + h0, y1)
        d2 = self._err_norm(vo.sub(f1, f0), y0, y0) / h0
        h1 = jnp.where((d1 <= 1e-15) & (d2 <= 1e-15),
                       jnp.maximum(1e-6, h0 * 1e-3),
                       (0.01 / jnp.maximum(d1, d2)) ** (1.0 / 6.0))
        return jnp.minimum(100 * h0, jnp.minimum(h1, t_final - t0))

    # ------------------------------------------------------------------
    def _solve(self, y0, t0, t_final, data=None, stop_aux=None):
        dtype = self.dtype
        mv = self._mv(data)
        n_c = y0.sinks.shape[0]

        def fsp_excess(t, y):
            if self.stop_check is None:
                return jnp.full((n_c,), -1.0, dtype)
            return jnp.asarray(self.stop_check(t, y, stop_aux),
                               dtype).reshape(n_c)

        h_init = self._initial_step(mv, t0, y0, t_final)

        def step(carry):
            (y, t, h, status, n_steps, n_rej, n_mv, stop, n_halve,
             viol, tr) = carry
            h = jnp.minimum(h, t_final - t)
            y5, err, n_stage = self._rk_step(mv, t, y, h)
            n_mv = n_mv + n_stage
            enorm = self._err_norm(err, y, y5)
            finite = vo.isfinite(y5) & jnp.isfinite(enorm)
            accept = (enorm <= 1.0) & finite
            # PI-ish controller (exponent = -1/(order+1) of the embedded
            # error estimate; subclasses with other orders override)
            factor = jnp.where(
                enorm > 0,
                jnp.clip(self.safety * enorm ** self._err_exp, 0.2, 10.0),
                10.0)
            h_new = h * factor

            status = jnp.where(finite, status, STATUS_FAILURE)

            # FSP check on accepted steps; violation => halve h, retry
            excess_v = fsp_excess(t + h, y5)
            viol = jnp.where(accept, jnp.maximum(viol, excess_v), viol)
            excess = jnp.where(accept, jnp.max(excess_v), -1.0)
            violated = accept & (excess > 0.0) & (n_halve < 10)
            give_up = accept & (excess > 0.0) & (n_halve >= 10)
            accept2 = accept & (excess <= 0.0)
            stop = jnp.where(accept2 & (n_halve > 0), 1, stop)
            # 10 failed halvings: stay at the previous state (the reference
            # takes t_step = 0 on the last trial, TsFsp.cpp:128-198)
            stop = jnp.where(give_up, 1, stop)
            y_out = vo.where(accept2, y5, y)
            t_out = jnp.where(accept2, t + h, t)
            h_out = jnp.where(violated, 0.5 * h,
                              jnp.where(accept2, h_new,
                                        jnp.where(accept, h, h_new)))
            n_halve = jnp.where(violated, n_halve + 1,
                                jnp.where(accept2, 0, n_halve))
            tr = trace_record(tr, n_steps, accept2, t + h, h, 7)
            n_steps = n_steps + jnp.where(accept2, 1, 0)
            n_rej = n_rej + jnp.where(accept2 | give_up, 0, 1)
            return (y_out, t_out, h_out, status, n_steps, n_rej, n_mv,
                    stop, n_halve, viol, tr)

        def cond(carry):
            t, status, n_steps, n_rej, stop = \
                carry[1], carry[3], carry[4], carry[5], carry[7]
            return (t < t_final) & (status == STATUS_OK) & (stop == 0) & \
                (n_steps + n_rej < self.max_steps)

        carry0 = (y0, t0, h_init, jnp.asarray(STATUS_OK, jnp.int32),
                  jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                  jnp.asarray(2, jnp.int32), jnp.asarray(0, jnp.int32),
                  jnp.asarray(0, jnp.int32), jnp.full((n_c,), -jnp.inf, dtype),
                  make_trace(self.trace_cap, dtype))
        (y, t, _, status, n_steps, n_rej, n_mv, stop, _, viol, tr) = \
            lax.while_loop(cond, step, carry0)
        status = jnp.where((status == STATUS_OK) & (stop == 1),
                           STATUS_FSP_STOP, status)
        status = jnp.where((status == STATUS_OK) & (t < t_final),
                           STATUS_FAILURE, status)
        return SolveResult(y=y, t=t, status=status,
                           stats=SolveStats(n_steps, n_rej, n_mv),
                           viol_excess=viol, trace=tr)
