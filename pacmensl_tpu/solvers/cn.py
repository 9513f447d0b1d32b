"""Implicit trapezoid (Crank-Nicolson) integrator — TsFsp "-ts_type cn".

The reference's TsFsp adapter accepts any PETSc TS method and auto-wires
``IFunction F = A p - p'`` / ``IJacobian A - aI`` for implicit types
(``src/OdeSolver/TsFsp.cpp:227-274``).  This module is the pluggable
second implicit method of that contract: the trapezoid rule

    (I - h/2 A(t+h)) y1 = (I + h/2 A(t)) y0

solved with matrix-free GMRES (the same machinery the BDF backend uses —
no assembled Jacobian, matching the reference's shell-operator usage).
The local error is estimated with an embedded backward-Euler companion
solve, ``err = y_CN - y_BE`` (BE is first order, so the estimate is the
leading local-error term and the controller exponent is -1/2), and FSP
stop-check handling (halve-and-retry, 10 trials) is inherited from the
shared TS-style step loop in :mod:`rk`.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops import vecops as vo
from ..ops.gmres import gmres
from .rk import RKSolver


class CNSolver(RKSolver):
    """Adaptive Crank-Nicolson with BE-embedded error control."""

    _err_exp = -0.5          # embedded estimate is order 1

    def _rk_step(self, mv, t, y, h):
        """One trapezoid step + BE companion: (y1, err, n_mv)."""
        lin_tol = max(1.0e-2 * self.rtol, 1.0e-14)
        f0 = mv(t, y)
        rhs = vo.axpy(0.5 * h, f0, y)
        t1 = t + h

        def A_cn(v):
            return vo.axpy(-0.5 * h, mv(t1, v), v)      # (I - h/2 A) v

        res = gmres(A_cn, rhs, y, tol=lin_tol, atol=self.atol,
                    dtype=self.dtype)
        y1 = res.x

        def A_be(v):
            return vo.axpy(-h, mv(t1, v), v)            # (I - h A) v

        res_be = gmres(A_be, y, y1, tol=lin_tol, atol=self.atol,
                       dtype=self.dtype)
        err = vo.sub(y1, res_be.x)
        n_mv = 1 + res.n_matvecs + res_be.n_matvecs
        # a stalled linear solve must reject the step, not silently pass:
        # inflate the error estimate when either GMRES did not converge
        bad = ~(res.converged & res_be.converged)
        err = vo.where(bad, vo.axpy(1.0, y1, err), err)
        return y1, err, n_mv
