"""Matrix-free restarted GMRES over FspVector pytrees.

Replaces the reference's PETSc SPGMR usage (CVODE's linear solver,
``src/OdeSolver/CvodeFsp.cpp:137-200``, and the stationary KSP solve,
``src/StationaryFsp/StationaryMCSolver.cpp``).  Fully jittable: Arnoldi with
modified Gram-Schmidt on padded [m+1] basis buffers, Givens-rotation
residual tracking for early exit, masked triangular solve, restarts in a
``lax.while_loop``.  No preconditioner (matching the reference's SPGMR
setup with PREC_NONE).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import DEFAULT_DTYPE
from . import vecops as vo


class GmresResult(NamedTuple):
    x: object
    res_norm: jnp.ndarray
    n_matvecs: jnp.ndarray
    converged: jnp.ndarray


def gmres(apply_A: Callable,
          b,
          x0,
          *,
          restart: int = 30,
          tol: float = 1.0e-10,
          atol: float = 1.0e-14,
          max_restarts: int = 40,
          dtype=None) -> GmresResult:
    """Solve A x = b (A a linear pytree->pytree map).  jnp-traceable."""
    dtype = dtype or DEFAULT_DTYPE
    m = restart
    bnorm = vo.norm2(b)
    target = jnp.maximum(tol * bnorm, atol)

    def cycle(carry):
        x, rnorm, nmv, it = carry
        r = vo.sub(b, apply_A(x))
        beta = vo.norm2(r)
        safe_beta = jnp.where(beta > 0, beta, 1.0)

        V = vo.stack_zeros(b, m + 1)
        V = vo.basis_set(V, 0, vo.scale(1.0 / safe_beta, r))
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)

        def arnoldi_body(carry):
            j, V, H, cs, sn, g, res, nmv = carry
            w = apply_A(vo.basis_get(V, j))
            nmv = nmv + 1

            def orth(i, c):
                w, H = c
                vi = vo.basis_get(V, i)
                hij = vo.vdot(w, vi)
                return (vo.axpy(-hij, vi, w), H.at[i, j].set(hij))

            w, H = lax.fori_loop(0, j + 1, orth, (w, H))
            hs = vo.norm2(w)
            H = H.at[j + 1, j].set(hs)
            V = vo.basis_set(V, j + 1,
                             vo.scale(1.0 / jnp.where(hs > 0, hs, 1.0), w))

            # apply stored Givens rotations to the new column
            def rot(i, Hcol):
                hi = cs[i] * Hcol[i] + sn[i] * Hcol[i + 1]
                hi1 = -sn[i] * Hcol[i] + cs[i] * Hcol[i + 1]
                return Hcol.at[i].set(hi).at[i + 1].set(hi1)

            col = lax.fori_loop(0, j, rot, H[:, j])
            # new rotation zeroing col[j+1]
            denom = jnp.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            denom = jnp.where(denom > 0, denom, 1.0)
            c_new, s_new = col[j] / denom, col[j + 1] / denom
            col = col.at[j].set(c_new * col[j] + s_new * col[j + 1])
            col = col.at[j + 1].set(0.0)
            H = H.at[:, j].set(col)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            g_j1 = -s_new * g[j]
            g = g.at[j + 1].set(g_j1).at[j].set(c_new * g[j])
            return (j + 1, V, H, cs, sn, g, jnp.abs(g_j1), nmv)

        def arnoldi_cond(carry):
            j, _, _, _, _, _, res, _ = carry
            return (j < m) & (res > target)

        j, V, H, cs, sn, g, res, nmv = lax.while_loop(
            arnoldi_cond, arnoldi_body,
            (0, V, H, cs, sn, g, beta, nmv))

        # masked upper-triangular solve H[:k,:k] yk = g[:k] by explicit
        # back-substitution (no TriangularSolve dependency; m is small)
        k = j
        diag_fix = jnp.where(jnp.arange(m) < k, 0.0, 1.0)
        Hk = H[:m, :] + jnp.diag(diag_fix)
        gk = jnp.where(jnp.arange(m) < k, g[:m], 0.0)

        def back_sub(i_rev, yk):
            i = m - 1 - i_rev
            resid = gk[i] - jnp.dot(Hk[i, :], yk)
            return yk.at[i].set(resid / Hk[i, i])

        yk = lax.fori_loop(0, m, back_sub, jnp.zeros((m,), dtype))
        coeffs = jnp.concatenate([yk, jnp.zeros((1,), dtype)])
        dx = vo.basis_lincomb(coeffs, V)
        x = vo.add(x, dx)
        return (x, res, nmv, it + 1)

    def outer_cond(carry):
        x, rnorm, nmv, it = carry
        return (rnorm > target) & (it < max_restarts)

    x, rnorm, nmv, it = lax.while_loop(
        outer_cond, cycle,
        (x0, jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32),
         jnp.asarray(0, jnp.int32)))
    return GmresResult(x=x, res_norm=rnorm, n_matvecs=nmv,
                       converged=rnorm <= target)
