"""Adaptive variable-order BDF integrator (CVODE parity).

Replaces the reference's SUNDIALS CVODE backend
(``src/OdeSolver/CvodeFsp.cpp``: BDF linear-multistep with matrix-free
SPGMR, no preconditioner): a quasi-constant-step-size variable-order
BDF(1-5) in the style of CVODE/scipy, with the Newton correction solved
exactly by matrix-free GMRES — the FSP right-hand side is *linear* in p,
so one linear solve per step replaces CVODE's Newton iteration.

The whole adaptive loop runs in one jitted ``lax.while_loop``.  The BDF
order is a traced integer dispatched with ``lax.switch`` over five
statically-shaped branches operating on a padded difference array D
(leading dim MAX_ORDER+3), which keeps every shape static while the order
adapts.

FSP stop semantics mirror CvodeFsp::Solve (CvodeFsp.cpp:34-78): the
stop-check runs after every accepted step; on violation the solver reverts
to the previous accepted state and returns status 1.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import DEFAULT_DTYPE
from ..ops import vecops as vo
from ..ops.gmres import gmres
from .base import (wrap_stop_check, make_trace, trace_record,
                   MatVec, StopCheck, SolveResult, SolveStats,
                   STATUS_OK, STATUS_FSP_STOP, STATUS_FAILURE,
                   STATUS_CONTINUE, mv_per_dispatch_default)

MAX_ORDER = 5
ND = MAX_ORDER + 3          # difference-array slots

_KAPPA = np.array([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0])
_GAMMA = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, MAX_ORDER + 1))])
_ALPHA = (1 - _KAPPA) * _GAMMA
_ERRC = _KAPPA * _GAMMA + 1.0 / np.arange(1, MAX_ORDER + 2)

MIN_FACTOR, MAX_FACTOR, SAFETY = 0.2, 10.0, 0.9
#: consecutive error-test/linear-solve failures before declaring a fatal
#: error (CVODE aborts after 7 error-test failures / 10 conv. failures)
MAX_CONSEC_REJ = 25


def _compute_RU(order: int, factor):
    """Static-order change-of-step matrix RU = R(factor) @ R(1)
    (CVODE/scipy D-array rescaling)."""
    q = order
    I = np.arange(1, q + 1)[:, None].astype(np.float64)
    J = np.arange(1, q + 1)[None, :].astype(np.float64)

    def R_of(fac):
        M = jnp.zeros((q + 1, q + 1))
        M = M.at[1:, 1:].set((I - 1 - fac * J) / I)
        M = M.at[0].set(1.0)
        return jnp.cumprod(M, axis=0)

    return R_of(factor) @ R_of(jnp.asarray(1.0))


class BdfSolver:
    """Variable-order BDF(1-5) + matrix-free GMRES over FspVectors."""

    def __init__(self,
                 matvec: MatVec,
                 *,
                 rtol: Optional[float] = None,
                 atol: float = 1.0e-14,
                 gmres_restart: int = 16,
                 gmres_tol: Optional[float] = None,
                 max_steps: int = 10_000_000,
                 mv_per_dispatch: Optional[int] = None,
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
        self.gmres_restart = int(gmres_restart)
        self.gmres_tol = float(gmres_tol if gmres_tol is not None
                               else (1.0e-5 if f32 else 1.0e-10))
        self.max_steps = int(max_steps)
        # matvec budget per jitted dispatch (see base.STATUS_CONTINUE)
        spd = (mv_per_dispatch if mv_per_dispatch is not None
               else mv_per_dispatch_default())
        self.mv_per_dispatch = int(spd) if spd else (1 << 62)
        self.trace_cap = int(trace_cap)
        self.stop_check = wrap_stop_check(stop_check)
        self._solve_jit = jax.jit(self._solve)

    def solve(self, y0, t0, t_final, data=None, stop_aux=None,
              mv_budget=None) -> SolveResult:
        """``data``: optional pytree forwarded to ``matvec(t, y, data)``
        so compiled programs stay valid across FSP expansion epochs;
        ``stop_aux`` likewise for the stop-check."""
        b = self.mv_per_dispatch if mv_budget is None else int(mv_budget)
        return self._solve_jit(y0, jnp.asarray(t0, self.dtype),
                               jnp.asarray(t_final, self.dtype), data,
                               stop_aux,
                               jnp.asarray(min(b, 1 << 30), jnp.int32))

    def _mv(self, data):
        if data is None:
            return self.matvec
        return lambda t, y: self.matvec(t, y, data)

    # -------------------------------------------------------------- util
    def _err_norm(self, err, scale_ref):
        tot, n = 0.0, 0
        for e, yref in zip(jax.tree_util.tree_leaves(err),
                           jax.tree_util.tree_leaves(scale_ref)):
            scale = self.atol + self.rtol * jnp.abs(yref)
            tot = tot + jnp.sum((e / scale) ** 2)
            n += e.size
        return jnp.sqrt(tot / n)

    # ------------------------------------------------------------------
    def _solve(self, y0, t0, t_final, data=None, stop_aux=None,
               mv_budget=None):
        dtype = self.dtype
        mv = self._mv(data)

        n_c = y0.sinks.shape[0]

        def fsp_excess(t, y):
            if self.stop_check is None:
                return jnp.full((n_c,), -1.0, dtype)
            return jnp.asarray(self.stop_check(t, y, stop_aux),
                               dtype).reshape(n_c)

        # ---- initial h (order-1 heuristic, as scipy BDF)
        f0 = mv(t0, y0)
        d1 = self._err_norm(f0, y0)
        h0 = jnp.where(d1 > 0, 0.01 / jnp.maximum(d1, 1e-30), 1e-6)
        h0 = jnp.clip(h0, 1e-12, (t_final - t0))

        D0 = vo.stack_zeros(y0, ND)
        D0 = vo.basis_set(D0, 0, y0)
        D0 = vo.basis_set(D0, 1, vo.scale(h0, f0))

        def rescale_D(D, order, factor):
            """D[:q+1] <- (RU)^T D[:q+1], statically per order branch."""
            def branch(q):
                def run(D):
                    RU = _compute_RU(q, factor)       # [q+1, q+1]
                    pad = jnp.zeros((ND, ND), dtype)
                    pad = pad.at[:q + 1, :q + 1].set(RU.T)
                    pad = pad.at[jnp.arange(q + 1, ND),
                                 jnp.arange(q + 1, ND)].set(1.0)
                    return jax.tree_util.tree_map(
                        lambda leaf: jnp.tensordot(
                            pad.astype(leaf.dtype), leaf, axes=1), D)
                return run
            return lax.switch(order - 1,
                              [branch(q) for q in range(1, MAX_ORDER + 1)], D)

        def predict(D, order):
            """(y_pred, psi) for the current order."""
            def branch(q):
                def run(D):
                    y_pred = vo.basis_get(D, 0)
                    for i in range(1, q + 1):
                        y_pred = vo.add(y_pred, vo.basis_get(D, i))
                    psi = vo.scale(_GAMMA[1] / _ALPHA[q], vo.basis_get(D, 1))
                    for i in range(2, q + 1):
                        psi = vo.axpy(_GAMMA[i] / _ALPHA[q],
                                      vo.basis_get(D, i), psi)
                    return y_pred, psi
                return run
            return lax.switch(order - 1,
                              [branch(q) for q in range(1, MAX_ORDER + 1)], D)

        def update_D(D, order, d):
            """Accepted step: push the new difference."""
            def branch(q):
                def run(args):
                    D, d = args
                    D = vo.basis_set(D, q + 2,
                                     vo.sub(d, vo.basis_get(D, q + 1)))
                    D = vo.basis_set(D, q + 1, d)
                    for i in range(q, -1, -1):
                        D = vo.basis_set(D, i, vo.add(vo.basis_get(D, i),
                                                      vo.basis_get(D, i + 1)))
                    return D
                return run
            return lax.switch(order - 1,
                              [branch(q) for q in range(1, MAX_ORDER + 1)],
                              (D, d))

        alpha_arr = jnp.asarray(_ALPHA, dtype)
        errc_arr = jnp.asarray(_ERRC, dtype)

        def step(carry):
            (D, t, h, order, n_eq, status, n_steps, n_rej, n_mv, stop,
             n_consec, viol, tr) = carry
            # truncate the final step; D encodes the step size, so rescale
            # (as scipy BDF does when hitting t_bound)
            h_clamped = jnp.minimum(h, t_final - t)
            clamp_fac = h_clamped / h
            D = lax.cond(clamp_fac < 1.0 - 1e-12,
                         lambda args: rescale_D(args[0], args[1], clamp_fac),
                         lambda args: args[0], (D, order))
            h = h_clamped
            t_new = t + h
            c = h / alpha_arr[order]

            y_pred, psi = predict(D, order)

            # linear solve: (I - c A) d = c A y_pred - psi
            def apply_M(v):
                return vo.axpy(-c, mv(t_new, v), v)

            rhs = vo.sub(vo.scale(c, mv(t_new, y_pred)), psi)
            sol = gmres(apply_M, rhs, vo.zeros_like(rhs),
                        restart=self.gmres_restart,
                        tol=self.gmres_tol, atol=self.atol,
                        dtype=dtype)
            d = sol.x
            n_mv = n_mv + sol.n_matvecs + 1
            y_new = vo.add(y_pred, d)

            err_norm = self._err_norm(vo.scale(errc_arr[order], d), y_pred)
            # a non-finite rhs means the user matvec failed: propagate
            # immediately (reference CvodeFsp propagates rhs error codes;
            # GMRES would otherwise mask the NaN by returning x0 unchanged)
            rhs_finite = vo.isfinite(rhs)
            finite = vo.isfinite(y_new) & jnp.isfinite(err_norm) & \
                sol.converged & rhs_finite
            accept = (err_norm <= 1.0) & finite
            status = jnp.where(vo.isfinite(y_new) & jnp.isfinite(err_norm)
                               & rhs_finite,
                               status, STATUS_FAILURE)

            # ---------- rejected: shrink h, rescale D
            of = order.astype(dtype)
            factor_rej = jnp.where(
                sol.converged,
                jnp.clip(SAFETY * err_norm ** (-1.0 / (of + 1)),
                         MIN_FACTOR, 1.0),
                jnp.asarray(0.5, dtype))   # linear solve stalled: just shrink
            # ---------- accepted: maybe adapt order after q+1 equal steps
            D_acc = update_D(D, order, d)
            n_eq_new = n_eq + 1

            def with_order_adapt(_):
                # error norms at order-1 / order+1 (scipy BDF)
                e_m = jnp.where(
                    order > 1,
                    self._err_norm(vo.scale(errc_arr[order - 1],
                                            vo.basis_get(D_acc, order)),
                                   y_pred),
                    jnp.asarray(jnp.inf, dtype))
                e_p = jnp.where(
                    order < MAX_ORDER,
                    self._err_norm(vo.scale(errc_arr[order + 1],
                                            vo.basis_get(D_acc, order + 2)),
                                   y_pred),
                    jnp.asarray(jnp.inf, dtype))
                errs = jnp.stack([e_m, jnp.maximum(err_norm, 1e-30), e_p])
                pows = of + jnp.arange(3, dtype=dtype)
                facs = jnp.where(errs > 0, errs ** (-1.0 / pows), MAX_FACTOR)
                delta = (jnp.argmax(facs) - 1).astype(order.dtype)
                new_order = jnp.clip(order + delta, 1, MAX_ORDER)
                factor = jnp.clip(SAFETY * jnp.max(facs),
                                  MIN_FACTOR, MAX_FACTOR)
                return new_order, factor

            def no_adapt(_):
                return order, jnp.asarray(1.0, dtype)

            order_acc, factor_acc = lax.cond(
                n_eq_new >= order + 1, with_order_adapt, no_adapt,
                operand=None)
            n_eq_out = jnp.where(n_eq_new >= order + 1, 0, n_eq_new)

            # ---------- FSP stop-check (CvodeFsp semantics: revert + stop)
            excess_v = fsp_excess(t_new, y_new)
            viol = jnp.where(accept, jnp.maximum(viol, excess_v), viol)
            excess = jnp.where(accept, jnp.max(excess_v), -1.0)
            violated = accept & (excess > 0.0)
            stop = jnp.where(violated, 1, stop)
            advance = accept & ~violated

            D_out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(advance, a, b), D_acc, D)
            order_out = jnp.where(advance, order_acc, order)
            factor_out = jnp.where(advance, factor_acc,
                                   jnp.where(accept, 1.0, factor_rej))
            n_eq_out = jnp.where(advance, n_eq_out, 0)
            t_out = jnp.where(advance, t_new, t)
            h_new = h * factor_out
            # keep h in range and rescale D accordingly
            D_out = lax.cond(
                jnp.abs(factor_out - 1.0) > 1e-12,
                lambda args: rescale_D(args[0], args[1], factor_out),
                lambda args: args[0],
                (D_out, order_out))

            tr = trace_record(tr, n_steps, advance, t_new, h, order)
            n_steps = n_steps + jnp.where(advance, 1, 0)
            n_rej = n_rej + jnp.where(accept, 0, 1)
            n_consec = jnp.where(accept, 0, n_consec + 1)
            status = jnp.where((n_consec >= MAX_CONSEC_REJ) &
                               (status == STATUS_OK),
                               STATUS_FAILURE, status)
            # minimum-step safeguard (scipy BDF min_step): a rejection that
            # drives h below float resolution of the time span is fatal
            min_step = 10.0 * jnp.finfo(dtype).eps * \
                jnp.maximum(jnp.abs(t_out), jnp.abs(t_final))
            status = jnp.where((~accept) & (h_new < min_step) &
                               (status == STATUS_OK),
                               STATUS_FAILURE, status)
            return (D_out, t_out, h_new, order_out, n_eq_out, status,
                    n_steps, n_rej, n_mv, stop, n_consec, viol, tr)

        def cond(carry):
            t, status, n_steps, n_rej, n_mv, stop = \
                carry[1], carry[5], carry[6], carry[7], carry[8], carry[9]
            return (t < t_final) & (status == STATUS_OK) & (stop == 0) & \
                (n_steps + n_rej < self.max_steps) & \
                (n_mv < mv_budget)

        carry0 = (D0, t0, h0, jnp.asarray(1, jnp.int32),
                  jnp.asarray(0, jnp.int32),
                  jnp.asarray(STATUS_OK, jnp.int32),
                  jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                  jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32),
                  jnp.asarray(0, jnp.int32),
                  jnp.full((n_c,), -jnp.inf, dtype),
                  make_trace(self.trace_cap, dtype))
        (D, t, h, order, n_eq, status, n_steps, n_rej, n_mv, stop,
         _n_consec, viol, tr) = lax.while_loop(cond, step, carry0)
        status = jnp.where((status == STATUS_OK) & (stop == 1),
                           STATUS_FSP_STOP, status)
        # exhausted the per-dispatch budget without reaching t_final:
        # resumable — the driver re-dispatches from (t, y) (see
        # base.STATUS_CONTINUE; the old fatal-at-max_steps semantics
        # only applied to pathological runs and the driver now detects
        # non-advancing resume loops instead)
        status = jnp.where((status == STATUS_OK) & (t < t_final),
                           STATUS_CONTINUE, status)
        return SolveResult(y=vo.basis_get(D, 0), t=t,
                           status=status,
                           stats=SolveStats(n_steps, n_rej, n_mv),
                           viol_excess=viol, trace=tr)
