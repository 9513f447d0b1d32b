"""Double-float (df64) stationary linear-solve engine for the box backend.

A float64-accurate path from float32 storage: the reference's
stationary driver inherits CPU float64 from PETSc
(``src/StationaryFsp/StationaryMCSolver.cpp`` — KSP GMRES on doubles),
while the f32 Jacobi-GMRES diverges on the repressilator.  This engine runs the same
rank-one-completed, Jacobi-left-preconditioned GMRES with every vector,
matvec and reduction in :mod:`..ops.df64` double-float arithmetic
(~1e-14 relative), entirely on the accelerator:

* per-reaction propensity grids are evaluated ONCE per capacity on the
  host CPU in true float64 (``jax.enable_x64`` scope) and shipped as
  (hi, lo) f32 pairs — operator entries carry f64 accuracy, so the
  stationary solution is not perturbed at f32 entry-rounding level;
* the matvec is the masked box stencil (zero-fill ``shift_nd`` on both
  components — data movement is error-free) with df64 products and
  compensated accumulation;
* Arnoldi (modified Gram-Schmidt) runs jitted in df64 on stacked basis
  pairs; the small (m+1, m) least-squares problem is solved per restart
  on the host in float64;
* sink outflows of the converged iterate are evaluated on the host in
  float64 exactly.

The jitted restart cycle takes the round's validity mask as DATA, so
every expansion round at the same capacity reuses one compiled program
(~2 device dispatches per restart).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops import df64 as dd
from ..ops.stencil import shift_nd


class Df64StationaryEngine:
    """Stationary ``(A + (2/n) d q^T) x = d`` solver in df64 on one box.

    Rebuild per capacity (propensity grids); per-round state (mask) is
    data to :meth:`solve`.
    """

    def __init__(self, model, space, restart: int = 30,
                 max_restarts: int = 200, verbose: int = 0):
        self.model = model
        self.space = space
        self.shape = tuple(int(s) for s in space.shape)
        self.m = int(restart)
        self.max_restarts = int(max_restarts)
        self.verbose = verbose
        self._assemble()
        self._build_jits()

    # ------------------------------------------------------------ build
    def _assemble(self):
        """Host-f64 propensity grids for the current capacity box."""
        from ..sys.environment import local_cpu_device
        shape = self.shape
        n = int(np.prod(shape))
        stoich = np.atleast_2d(np.asarray(self.model.stoichiometry,
                                          np.int64))
        R = stoich.shape[0]
        cpu = local_cpu_device()
        grids64 = []
        CH = 1 << 22
        with jax.enable_x64(True):
            with jax.default_device(cpu):
                for r in range(R):
                    parts = []
                    for lo in range(0, n, CH):
                        hi = min(lo + CH, n)
                        idx = np.arange(lo, hi, dtype=np.int64)
                        coords = np.stack(
                            np.unravel_index(idx, shape), axis=1)
                        a = np.asarray(jax.device_get(
                            self.model.propensity(
                                jnp.asarray(coords, jnp.float64), r)),
                            np.float64)
                        parts.append(a)
                    grids64.append(np.concatenate(parts))
        self._a64 = grids64                       # host, for exact sinks
        self._stoich = stoich
        self.n_box = n
        # device df64 pairs, box-shaped
        self._a_dd = [tuple(jnp.reshape(c, shape) for c in dd.from_f64(g))
                      for g in grids64]

    def _build_jits(self):
        shape = self.shape
        stoich = self._stoich
        m = self.m
        a_dd = self._a_dd

        def prep(mask_f):
            """(d, inv_d, b) of the round: diag, Jacobi scale, rhs."""
            d = dd.dd(jnp.zeros(shape, jnp.float32))
            for r in range(stoich.shape[0]):
                d = dd.add(d, a_dd[r])
            d = (-d[0] * mask_f, -d[1] * mask_f)
            valid = jnp.abs(d[0]) > 1e-30
            safe = dd.where(valid, d, dd.dd(jnp.ones(shape, jnp.float32)))
            inv_d = dd.recip(safe)
            b = (jnp.where(valid, 1.0, 0.0).astype(jnp.float32),
                 jnp.zeros(shape, jnp.float32))
            return d, safe, inv_d, b

        def apply_A(x, mask_f):
            xm = (x[0] * mask_f, x[1] * mask_f)
            out = dd.dd(jnp.zeros(shape, jnp.float32))
            for r in range(stoich.shape[0]):
                ap = dd.mul(a_dd[r], xm)
                ap = (ap[0] * mask_f, ap[1] * mask_f)
                s = stoich[r]
                inflow = (shift_nd(ap[0], s), shift_nd(ap[1], s))
                out = dd.add(out, dd.sub(inflow, ap))
            return (out[0] * mask_f, out[1] * mask_f)

        def M(x, mask_f, d, inv_d, ton):
            av = apply_A(x, mask_f)
            alpha = dd.mul_f(dd.asum(x), ton)
            av = dd.add(av, dd.scale(alpha, d))
            return dd.mul(av, inv_d)

        def cycle(xh, xl, mask_f, ton):
            d, safe, inv_d, b = prep(mask_f)
            x = (xh, xl)
            r = dd.sub(b, M(x, mask_f, d, inv_d, ton))
            beta = dd.norm2(r)
            beta_f = beta[0] + beta[1]
            safe_beta = jnp.where(beta_f > 0, beta_f, 1.0)
            v0 = dd.mul_f(r, 1.0 / safe_beta)
            Vh = jnp.zeros((m + 1,) + shape, jnp.float32).at[0].set(v0[0])
            Vl = jnp.zeros((m + 1,) + shape, jnp.float32).at[0].set(v0[1])
            H = jnp.zeros((m + 1, m), jnp.float32)
            Hl = jnp.zeros((m + 1, m), jnp.float32)

            def body(j, carry):
                Vh, Vl, H, Hl = carry
                vj = (lax.dynamic_index_in_dim(Vh, j, 0, False),
                      lax.dynamic_index_in_dim(Vl, j, 0, False))
                w = M(vj, mask_f, d, inv_d, ton)

                def orth(i, c):
                    w, H, Hl = c
                    vi = (lax.dynamic_index_in_dim(Vh, i, 0, False),
                          lax.dynamic_index_in_dim(Vl, i, 0, False))
                    h = dd.dot(vi, w)
                    use = i <= j
                    h = (jnp.where(use, h[0], 0.0),
                         jnp.where(use, h[1], 0.0))
                    w = dd.sub(w, dd.scale(h, vi))
                    H = H.at[i, j].set(h[0])
                    Hl = Hl.at[i, j].set(h[1])
                    return (w, H, Hl)

                w, H, Hl = lax.fori_loop(0, m + 1, orth, (w, H, Hl))
                hn = dd.norm2(w)
                hn_f = hn[0] + hn[1]
                H = H.at[j + 1, j].set(hn[0])
                Hl = Hl.at[j + 1, j].set(hn[1])
                wn = dd.mul_f(w, jnp.where(hn_f > 0, 1.0 / hn_f, 0.0))
                Vh = lax.dynamic_update_index_in_dim(Vh, wn[0], j + 1, 0)
                Vl = lax.dynamic_update_index_in_dim(Vl, wn[1], j + 1, 0)
                return (Vh, Vl, H, Hl)

            Vh, Vl, H, Hl = lax.fori_loop(0, m, body, (Vh, Vl, H, Hl))
            return Vh, Vl, H, Hl, beta[0], beta[1]

        def combine(xh, xl, Vh, Vl, yh, yl):
            x = (xh, xl)

            def body(k, x):
                vk = (lax.dynamic_index_in_dim(Vh, k, 0, False),
                      lax.dynamic_index_in_dim(Vl, k, 0, False))
                return dd.add(x, dd.scale((yh[k], yl[k]), vk))

            return lax.fori_loop(0, m, body, x)

        def resid_norms(xh, xl, mask_f, ton):
            d, safe, inv_d, b = prep(mask_f)
            rp = dd.sub(b, M((xh, xl), mask_f, d, inv_d, ton))
            rn = dd.norm2(rp)
            raw = dd.mul(rp, safe)                    # D * r_pre
            rwn = dd.norm2(raw)
            return rn[0] + rn[1], rwn[0] + rwn[1]

        self._cycle = jax.jit(cycle)
        self._combine = jax.jit(combine)
        self._resid = jax.jit(resid_norms)

    # ------------------------------------------------------------ solve
    def solve(self, x0_f32, mask_host, gmres_tol: float = 1.0e-12):
        """Restarted df64 GMRES; returns ``(pi64, converged, rnorm,
        raw_norm)`` with ``pi64`` the normalized stationary vector as
        host float64 over the flat box."""
        shape = self.shape
        m = self.m
        mask_f = jnp.asarray(mask_host.astype(np.float32)).reshape(shape)
        n_valid = float(mask_host.sum())
        ton = jnp.float32(2.0 / n_valid)
        bnorm = float(np.sqrt(n_valid))               # ||1_valid||
        target = gmres_tol * bnorm
        x = dd.dd(jnp.asarray(x0_f32, jnp.float32).reshape(shape))
        converged = False
        rnorm = np.inf
        for it in range(self.max_restarts):
            Vh, Vl, H, Hl, bh, bl = self._cycle(x[0], x[1], mask_f, ton)
            Hh = np.asarray(jax.device_get(H), np.float64) + \
                np.asarray(jax.device_get(Hl), np.float64)
            beta = float(np.asarray(jax.device_get(bh), np.float64) +
                         np.asarray(jax.device_get(bl), np.float64))
            if beta <= target:
                converged = True
                rnorm = beta
                break
            g = np.zeros(m + 1)
            g[0] = beta
            y, *_ = np.linalg.lstsq(Hh, g, rcond=None)
            yh = y.astype(np.float32)
            yl = (y - yh.astype(np.float64)).astype(np.float32)
            x = self._combine(x[0], x[1], Vh, Vl,
                              jnp.asarray(yh), jnp.asarray(yl))
            rnorm = float(np.linalg.norm(g - Hh @ y))
            if self.verbose >= 2:
                print(f"[df64-gmres] restart {it}: rnorm {rnorm:.3e} "
                      f"target {target:.3e}", flush=True)
            if rnorm <= target:
                converged = True
                break
        rn_f, raw_f = jax.device_get(
            self._resid(x[0], x[1], mask_f, ton))
        xh, xl = jax.device_get((x[0], x[1]))
        pi64 = (np.asarray(xh, np.float64) +
                np.asarray(xl, np.float64)).reshape(-1)
        pi64 = pi64 * mask_host.reshape(-1)
        tot = pi64.sum()
        if tot != 0:
            pi64 = pi64 / tot
        return pi64, converged, float(rn_f), float(raw_f)

    # ----------------------------------------------------------- sinks
    def sinks_host(self, pi64, mask_host, constraints) -> np.ndarray:
        """Exact host-f64 sink outflows of ``pi64`` under the CURRENT
        constraint bounds (reference EvaluateOutflows,
        ``StationaryFspMatrixConstrained.cpp:175``)."""
        shape = self.shape
        n = self.n_box
        n_c = constraints.num_constraints
        out = np.zeros(n_c, np.float64)
        maskf = mask_host.reshape(-1).astype(np.float64)
        CH = 1 << 22
        from ..sys.environment import local_cpu_device
        cpu = local_cpu_device()
        with jax.enable_x64(True):
            with jax.default_device(cpu):
                for lo in range(0, n, CH):
                    hi = min(lo + CH, n)
                    idx = np.arange(lo, hi, dtype=np.int64)
                    coords = np.stack(np.unravel_index(idx, shape), axis=1)
                    w = pi64[lo:hi] * maskf[lo:hi]
                    for r in range(self._stoich.shape[0]):
                        ap = self._a64[r][lo:hi] * w
                        tgt = coords + self._stoich[r][None, :]
                        vals = np.asarray(jax.device_get(
                            constraints.values_fn(
                                jnp.asarray(tgt, jnp.float64))),
                            np.float64)
                        viol = vals > np.asarray(constraints.bounds,
                                                 np.float64)[None, :]
                        out += (ap[:, None] * viol).sum(axis=0)
        return out
