"""FSP shape constraints.

Equivalent of the reference's constraint machinery in
``StateSetConstrained`` (``src/StateSet/StateSetConstrained.h:35-68``): the
truncated state space is ``{x : f_i(x) <= b_i for all i}`` where ``f`` is a
user-supplied vectorized function returning integer scores and ``b`` are
integer bounds.  The default constraint is coordinate-wise
(``f_i(x) = x_i``; reference ``StateSetConstrained.cpp:92-99``).

Constraint functions here are jnp-traceable and batched:
``fn(states[n, S]) -> [n, n_constraints]`` — they trace into both the
device-side BFS (box backend) and the sink-weight computation of the
operators, so constraint checking costs no extra memory traffic.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..sys.errors import StateSpaceError


class ConstraintSet:
    """Bundle of (constraint function, RHS bounds, expansion factors).

    Evaluations are routed through cached jitted callables: on accelerator
    platforms where every eager op pays a dispatch/compile round-trip, host-side
    constraint sweeps (bounding-box search, mask building, BFS candidate
    filtering) would otherwise dominate assembly time.
    """

    def __init__(self,
                 fn: Optional[Callable],
                 bounds,
                 expansion_factors=None,
                 num_species: Optional[int] = None,
                 box_cache: Optional[dict] = None,
                 jit_cache: Optional[dict] = None):
        #: memo for derive_box_bounds, SHARED through with_bounds copies:
        #: an adaptive solve re-derives the bounding box of every epoch's
        #: bounds several times (backend routing, migration check, space
        #: build + face-closure retries) and each derivation costs ~0.4 s
        #: of host corner-probe bisection — measured at ~40 s of a 140 s
        #: flagship solve before this cache.
        self._box_cache = box_cache if box_cache is not None else {}
        #: the jitted host-side score function, shared through
        #: with_bounds copies (see _host_values)
        self._jit_cache = jit_cache if jit_cache is not None else {}
        self.fn = fn
        self.bounds = np.asarray(bounds, dtype=np.int64).reshape(-1)
        if expansion_factors is None:
            expansion_factors = np.full(self.bounds.shape, 0.25)
        self.expansion_factors = np.asarray(
            expansion_factors, dtype=np.float64).reshape(-1)
        if self.expansion_factors.shape != self.bounds.shape:
            raise StateSpaceError(
                "expansion_factors and bounds must have equal length "
                f"({self.expansion_factors.shape} vs {self.bounds.shape})")
        self.num_species = num_species
        if fn is None and num_species is not None and \
                len(self.bounds) != num_species:
            raise StateSpaceError(
                "default (coordinate-wise) constraints need one bound per "
                f"species: {len(self.bounds)} bounds, {num_species} species")

    @property
    def num_constraints(self) -> int:
        return self.bounds.shape[0]

    def _values_impl(self, states) -> jnp.ndarray:
        if self.fn is None:
            return states  # coordinate-wise default
        vals = jnp.asarray(self.fn(states))
        return vals.reshape(states.shape[0], self.num_constraints)

    def _host_values(self, states) -> np.ndarray:
        """Constraint scores of host states, evaluated on the CPU backend.

        Host-side sweeps (BFS candidate filtering, bounding-box search,
        operator assembly) arrive with a new row count almost every call.
        Rows are zero-padded to the next power of two (at least 256), so
        one compiled program per size class serves a whole adaptive
        solve; the jit is shared through :meth:`with_bounds` copies (the
        function is epoch-stable and bounds never enter it).
        Device-side callers go through :meth:`values_fn` /
        :meth:`satisfied_with` instead, which trace into the enclosing
        jitted program.
        """
        states = np.atleast_2d(np.asarray(states, dtype=np.int64))
        if self.fn is None:
            return states                  # coordinate-wise default
        jf = self._jit_cache.get("values")
        if jf is None:
            jf = jax.jit(self._values_impl)
            self._jit_cache["values"] = jf
        n = states.shape[0]
        buf = np.zeros((max(256, 1 << max(n - 1, 0).bit_length()),
                        states.shape[1]), np.int64)
        buf[:n] = states
        from ..sys.environment import local_cpu_device
        cpu = local_cpu_device()
        with jax.default_device(cpu):
            out = jf(jax.device_put(buf, cpu))
        return np.asarray(out)[:n]

    def values(self, states) -> jnp.ndarray:
        """Constraint scores f(x): [n, n_constraints] (jnp-traceable)."""
        if isinstance(states, jax.core.Tracer):
            return self._values_impl(states)
        return self._host_values(states)

    def _satisfied_impl(self, states) -> jnp.ndarray:
        b = jnp.asarray(self.bounds)
        return self._values_impl(states) <= b[None, :]

    def satisfied(self, states) -> jnp.ndarray:
        """Per-constraint satisfaction bitmap [n, n_constraints] (bool).

        Reference ``StateSetConstrained::CheckConstraints``
        (StateSetConstrained.cpp:63-82).
        """
        if isinstance(states, jax.core.Tracer):
            return self._satisfied_impl(states)
        return self._host_values(states) <= self.bounds[None, :]

    def values_fn(self, states) -> jnp.ndarray:
        """Raw constraint scores, trace-only (no jit wrapper, no bounds).

        Use inside already-jitted programs that compare against *traced*
        bounds — the capacity-stable formulation where bounds are data,
        not compile-time constants."""
        return self._values_impl(states)

    def satisfied_with(self, states, bounds) -> jnp.ndarray:
        """Per-constraint bitmap against a *traced* bounds vector.

        Same semantics as :meth:`satisfied`, but the RHS comes from the
        argument instead of ``self.bounds`` so one compiled program serves
        every expansion epoch at a fixed array capacity."""
        b = jnp.asarray(bounds)
        return self._values_impl(states) <= b[None, :]

    def all_satisfied(self, states) -> jnp.ndarray:
        if isinstance(states, jax.core.Tracer):
            return jnp.all(self._satisfied_impl(states), axis=1)
        return self._all_satisfied_with(states, self.bounds)

    def expanded_bounds(self, to_expand) -> np.ndarray:
        """Grow the flagged bounds by their expansion factors.

        Uses the reference's exact growth formula
        ``b <- round(b*(1+f) + 0.5)`` (FspSolverMultiSinks.cpp:120-121).
        """
        to_expand = np.asarray(to_expand, dtype=bool).reshape(-1)
        new_bounds = self.bounds.copy()
        grow = np.round(self.bounds * (self.expansion_factors + 1.0) + 0.5)
        new_bounds[to_expand] = grow[to_expand].astype(np.int64)
        return new_bounds

    def with_bounds(self, bounds) -> "ConstraintSet":
        return ConstraintSet(self.fn, bounds, self.expansion_factors,
                             self.num_species, box_cache=self._box_cache,
                             jit_cache=self._jit_cache)

    def _all_satisfied_with(self, states, bounds) -> np.ndarray:
        """Host-side all-constraints check against the given bounds."""
        bounds = np.asarray(bounds, dtype=np.int64)
        return (self._host_values(states) <= bounds[None, :]).all(axis=1)

    def derive_box_bounds(self, num_species: int, init_states,
                          cap: int = 1 << 22) -> np.ndarray:
        """Per-species bounding box [b_0..b_{S-1}] of the constraint set.

        For default constraints the box is exactly the bounds.  For custom
        constraint functions, finds for each species the largest
        coordinate v such that SOME witness state with ``x_i = v``
        satisfies every constraint.  Witnesses place the other coordinates
        at every corner combination of {0, current box bound} — an
        axis-ray probe alone under-covers coordinate-*gated* constraints
        like hog1p's ``(x0==g)*(x1+x2) <= b`` (hog1p_3d_model.h), where
        x1's reach depends on x0 being away from 0.  Passes repeat until
        the box stops growing (corner values depend on other axes'
        bounds).  Assumes scores are non-decreasing in each coordinate at
        fixed others beyond the corner set — true for every
        bundled/reference model; the StateSet additionally self-heals by
        growing its key space dynamically, and the box backend verifies
        face-closure after mask construction.
        """
        init_arr = np.atleast_2d(np.asarray(init_states, dtype=np.int64))
        key = (num_species, self.bounds.tobytes(), init_arr.tobytes(), cap)
        if key in self._box_cache:
            return self._box_cache[key].copy()
        if self.fn is None:
            box = self.bounds.copy()
        else:
            box = self._probe_box(num_species, init_arr, cap)
        out = np.maximum(box, init_arr.max(axis=0))
        self._box_cache[key] = out.copy()
        return out

    def _probe_box(self, num_species: int, init_arr, cap: int) -> np.ndarray:
        """Corner-witness probe for custom constraint functions, batched:
        ONE ``all_satisfied`` call per search step covers every species'
        witnesses at once, and the search warm-starts (gallop + bisect)
        from the last box derived for this constraint function — adaptive
        solves re-derive the box every expansion epoch with slightly
        grown bounds, so the warm bracket is tight and the per-epoch cost
        drops from ~0.2 s (22 bisection dispatches x species x corners)
        to a few milliseconds (measured: LeaveBoxCheck 10.6 s of a 60 s
        flagship solve before this rewrite)."""
        S = num_species
        lastkey = ("last", S, init_arr.tobytes(), cap)
        warm = self._box_cache.get(lastkey)
        box = np.zeros(S, dtype=np.int64)
        for _ in range(1 + S):
            prev = box.copy()
            blocks, spec_of = [], []
            for i in range(S):
                others = [d for d in range(S) if d != i]
                grid = np.array(
                    np.meshgrid(*[[0, int(box[d])] for d in others]),
                    dtype=np.int64).reshape(len(others), -1).T \
                    if others else np.zeros((1, 0), np.int64)
                corners = np.unique(grid, axis=0)
                w = np.zeros((corners.shape[0], S), np.int64)
                w[:, others] = corners
                blocks.append(w)
                spec_of.append(np.full(corners.shape[0], i))
            W = np.concatenate(blocks, axis=0)
            sp = np.concatenate(spec_of)
            n_rows = W.shape[0]
            rows = np.arange(n_rows)

            def feas_grid(cands):
                """cands: [S, K] candidate values -> feasible [S, K]
                (some witness with x_i = cands[i, k] satisfies every
                constraint).  ONE batched evaluation for the whole grid —
                the search is host-dispatch-bound, not compute-bound."""
                K = cands.shape[1]
                Wk = np.broadcast_to(W, (K,) + W.shape).copy()
                Wk[:, rows, sp] = cands[sp, :].T
                ok = self._all_satisfied_with(
                    Wk.reshape(K * n_rows, S),
                    self.bounds).reshape(K, n_rows)
                out = np.zeros((S, K), dtype=bool)
                for i in range(S):
                    out[i] = ok[:, sp == i].any(axis=1)
                return out

            # Monotone grid search: lo = largest feasible value seen,
            # hi = smallest infeasible seen - 1; each round evaluates a
            # K-point grid in (lo, hi] and shrinks the bracket ~K-fold,
            # so 2 calls resolve a warm bracket and ~4 a cold one (vs
            # ~22 sequential bisection dispatches).
            K = 64
            lo = np.zeros(S, dtype=np.int64)
            hi = np.full(S, cap, dtype=np.int64)
            first = True
            for _round in range(10):
                act = lo < hi
                if not act.any():
                    break
                cands = np.zeros((S, K), dtype=np.int64)
                for i in range(S):
                    if not act[i]:
                        cands[i] = lo[i]
                        continue
                    if first:
                        # warm window + geometric ladder to the cap
                        w_i = (int(warm[i]) if warm is not None
                               else 0)
                        win = np.linspace(max(w_i, 1),
                                          w_i + w_i // 4 + 2, 40)
                        geo = np.geomspace(1, cap, K - 40)
                        c = np.concatenate([win, geo])
                    else:
                        c = np.linspace(lo[i] + 1, hi[i], K)
                    cands[i] = np.clip(np.round(c).astype(np.int64),
                                       lo[i] + 1, hi[i])
                f = feas_grid(cands)
                for i in range(S):
                    if not act[i]:
                        continue
                    ci = cands[i]
                    if f[i].any():
                        lo[i] = max(lo[i], int(ci[f[i]].max()))
                    bad = ci[~f[i]]
                    bad = bad[bad > lo[i]]
                    if bad.size:
                        hi[i] = min(hi[i], int(bad.min()) - 1)
                    hi[i] = max(hi[i], lo[i])
                first = False
            box = lo
            if (box == prev).all():
                break
        self._box_cache[lastkey] = box.copy()
        return box
