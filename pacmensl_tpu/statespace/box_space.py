"""Dense bounding-box state space.

Re-design of the reference ``StateSetConstrained``
(``src/StateSet/StateSetConstrained.cpp:132-221``) for an accelerator:
instead of an
explicit distributed list of states plus a Zoltan distributed hash table, the
state space is the dense bounding box of the constraint set with a boolean
**validity mask** = (constraints satisfied) AND (reachable from the initial
states).

* The reference's distributed frontier BFS becomes a vectorized mask
  dilation on device: ``mask |= shift(mask, s_r); mask &= constraint_ok``
  iterated to a fixed point (`expand`).  One XLA while-loop replaces the
  whole Zoltan DD probe/update/find machinery because position in the box
  *is* the state's identity — no hash table needed.
* ``State2Index`` (reference ``StateSetBase.cpp:309-343``) becomes mixed-
  radix linearization into the box (`state2index`).
* Expansion embeds the old box in the new one with a zero pad — the
  ``ExpandVec`` scatter (``src/PetscWrap/PetscWrap.cpp:26-56``) becomes a
  static pad.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import DEFAULT_DTYPE
from ..sys.errors import StateSpaceError
from ..sys import indexing
from ..ops.stencil import shift_nd, coord_grid, box_shape_from_bounds
from .constraints import ConstraintSet


@partial(jax.jit, static_argnames=("shifts", "max_iters"))
def _bfs_closure(seed_mask: jnp.ndarray, ok_mask: jnp.ndarray,
                 shifts: Tuple[Tuple[int, ...], ...],
                 max_iters: int) -> jnp.ndarray:
    """Reachability closure of ``seed_mask`` under the reaction shifts,
    restricted to ``ok_mask`` (vectorized frontier BFS; the device analogue
    of StateSetConstrained::Expand's frontier loop)."""

    def dilate(mask):
        out = mask
        for s in shifts:
            out = out | shift_nd(mask, s)
        return out & ok_mask

    def body(carry):
        mask, _, it = carry
        new = dilate(mask)
        changed = jnp.any(new != mask)
        return new, changed, it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_iters)

    mask0 = seed_mask & ok_mask
    mask, _, _ = lax.while_loop(cond, body, (mask0, jnp.bool_(True), 0))
    return mask


#: Geometric capacity ladder (x1.5 steps).  Box axes are allocated at
#: ladder sizes so that expansion epochs usually reuse the existing array
#: capacity — and hence the existing compiled XLA programs, whose only
#: epoch-dependent inputs (bounds, mask) are runtime data.  This is the
#: "recompile only on capacity growth" strategy of SURVEY.md §7: the
#: reference rebuilds its PETSc matrices every expansion, but a rebuild
#: there costs milliseconds while an XLA recompile costs seconds.
def _ladder(n: int) -> int:
    c = 4
    while c < n:
        c = max(c + 1, int(c * 3 / 2))
    return c


def _round_capacity(n: int, quantum: int = 1) -> int:
    c = _ladder(int(n))
    q = int(quantum)
    return -(-c // q) * q


def _round_fine(n: int, quantum: int = 1) -> int:
    """Fine-grained axis rounding for BUDGETED preallocation: lcm(8, q)
    multiples.  The x1.5 ladder compounds to ~5x element inflation over
    4 growable axes — redundant there, because recompile frequency is
    already governed by the element-level HEADROOM target (x8), not by
    per-axis rungs.  (The lazy/CPU path keeps the ladder.)"""
    import math
    q = max(int(quantum), 1)
    m = 8 * q // math.gcd(8, q) if int(n) > 32 else q
    return max(-(-int(n) // m) * m, m)


#: Hard cap on box-backend capacity (elements).  A runaway expansion should
#: fail with a diagnosable StateSpaceError, not an opaque device OOM — the
#: Krylov integrator keeps ~m_max basis vectors alive, so usable box sizes
#: are well below raw-HBM/4B anyway.
MAX_BOX_ELEMS = int(float(os.environ.get("PACMENSL_MAX_BOX_ELEMS", "3e8")))


class BoxStateSpace:
    """Constraint-shaped state space on a dense bounding box.

    The allocated array shape (:attr:`shape`) is a *capacity*: each axis is
    the bounding-box extent rounded up the capacity ladder.  The validity
    mask excludes padded states, so padding never changes results; bound
    growth that stays within capacity changes only the mask (data), not any
    array shape (program)."""

    def __init__(self,
                 stoichiometry: np.ndarray,
                 constraints: ConstraintSet,
                 init_states,
                 track_reachability: bool = True,
                 pad_quanta=None,
                 prealloc_budget: Optional[float] = None,
                 growable_axes=None,
                 build_on_device: bool = False,
                 extent_floor=None,
                 seed_mask_fn=None):
        """``pad_quanta``: per-axis size quanta; each capacity axis is
        rounded up to a multiple of its quantum (used to make the sharded
        axis divisible by the mesh size).

        ``prealloc_budget``: element budget for *eager capacity
        allocation*.  Adaptive FSP solves grow their bounds dozens of
        times; every capacity change is an XLA recompile of the whole
        jitted solve (seconds), while running the stencil on a
        larger-than-needed box costs only proportional device work.  With a budget set, capacities are
        water-filled up-front — all growable axes share a common cap C
        chosen so the box fills the budget — so the entire adaptive solve
        usually runs at ONE set of shapes (one compile).  ``growable_axes``
        limits the water-filling to axes that can actually grow (e.g.
        coordinate-bound axes with a positive expansion factor).

        ``build_on_device``: run the mask builder (constraint check + BFS
        reachability) on the default device instead of the host CPU
        backend — the right choice whenever capacity is stable (one
        compile) and the box is large (device BFS is memory-bound at HBM
        speed; the host copy of the mask becomes lazy).
        """
        self.stoich = np.atleast_2d(np.asarray(stoichiometry, dtype=np.int64))
        self.constraints = constraints
        self.init_states = np.atleast_2d(
            np.asarray(init_states, dtype=np.int64))
        if self.init_states.shape[1] != self.num_species:
            raise StateSpaceError(
                f"init states have {self.init_states.shape[1]} species, "
                f"stoichiometry has {self.num_species}")
        self.track_reachability = track_reachability
        self.pad_quanta = (np.ones(self.num_species, dtype=np.int64)
                           if pad_quanta is None
                           else np.asarray(pad_quanta, dtype=np.int64))
        self.prealloc_budget = (None if prealloc_budget is None
                                else float(prealloc_budget))
        self.growable_axes = (np.ones(self.num_species, dtype=bool)
                              if growable_axes is None
                              else np.asarray(growable_axes, dtype=bool))
        self.build_on_device = bool(build_on_device)
        #: per-axis minimum extents (the reorder rebuild passes the old
        #: space's extents so the new box provably embeds it)
        self.extent_floor = (None if extent_floor is None
                             else np.asarray(extent_floor, np.int64))
        self._shape = None
        self._mask_builder = None
        self._prev_mask = None      # incremental BFS seed (device or host)
        #: optional callable(shape) -> bool mask of already-known
        #: reachable states at the given capacity, used once as the first
        #: build's BFS seed.  The reorder rebuild passes the previous
        #: space's mask (transposed into the new layout): a fresh BFS
        #: from the initial states needs ~set-diameter dilation passes
        #: over the box, while the seeded BFS converges in a handful
        #: (hog1p's 7 reorder rungs dominated StatePartitioning).
        self._seed_mask_fn = seed_mask_fn
        self._build()

    # ------------------------------------------------------------ basics
    @property
    def num_species(self) -> int:
        return self.stoich.shape[1]

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    @property
    def num_constraints(self) -> int:
        return self.constraints.num_constraints

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def size(self) -> int:
        return int(np.prod(self._shape))

    @property
    def mask(self) -> jnp.ndarray:
        """Validity mask over the box (True = state belongs to the FSP set).

        In device-build mode this IS the builder's output (no host
        round-trip); otherwise it is materialized on the default backend
        lazily, so a host-built solve's first device traffic is the
        solution vector itself."""
        if self._mask is None:
            self._mask = jnp.asarray(self._mask_host_cache)
        return self._mask

    @property
    def num_states(self) -> int:
        """Number of valid states (reference GetNumGlobalStates)."""
        return self._num_states

    @property
    def bounds(self) -> np.ndarray:
        return self.constraints.bounds

    # ------------------------------------------------------------- build
    def _build(self):
        """Build shape+mask, then verify FACE CLOSURE: no valid state on a
        capacity face may have a constraint-satisfying outward neighbor —
        otherwise the box truncates the true set and the operator would
        destroy (not sink) the outward flux.  Under-coverage can happen
        when coordinate-gated constraints defeat the corner probe of
        ``derive_box_bounds``; leaking axes are grown and the build
        repeats.  (The leak bits come out of the same jitted mask-builder
        program as the mask itself — one fused device sweep, no host
        enumeration of face states.)"""
        for _ in range(64):
            self._build_once()
            leaks = self._leaks
            if not leaks.any():
                return
            floor = getattr(self, "_box_floor",
                            np.zeros(self.num_species, np.int64))
            grown = np.asarray(self._shape, np.int64)  # face idx = shape-1
            floor = np.maximum(floor, np.where(leaks, (grown * 5) // 4 + 1,
                                               0))
            self._box_floor = floor
        raise StateSpaceError(
            "box face closure did not converge: the constraint set appears "
            "unbounded along axes "
            f"{np.nonzero(self._leaks)[0].tolist()}")

    def _prealloc_shape(self, raw_shape) -> tuple:
        """Water-filled capacity: all growable axes share a common cap C,
        chosen (binary search) so the box fills — but does not exceed —
        the element target; non-growable axes stay at their ladder size.
        Monotone over the existing allocation.

        The target is ``min(budget, need * HEADROOM)`` rather than the
        whole budget: filling the full budget guaranteed ONE compile for
        the whole adaptive solve but ran every matvec and basis-vector op
        at the budget size regardless of need (the flagship's 3.9M-state
        final box computed on a 32M-element allocation — measured ~72% of
        the advance loop).  With 8x headroom the capacity tracks need
        within a factor of 8 (one recompile per ~8x element growth, a
        handful per solve, absorbed by the persistent compile cache on
        repeat runs) while matvec cost stays within ~8x of optimal.
        PACMENSL_BOX_HEADROOM=0
        restores fill-the-budget."""
        ext = np.maximum(np.asarray(raw_shape, np.int64),
                         np.asarray(self._shape or [0] * len(raw_shape),
                                    np.int64))
        grow = self.growable_axes
        budget = min(self.prealloc_budget, float(MAX_BOX_ELEMS))

        def dims_for(C):
            return tuple(
                _round_fine(max(int(e), C if g else 0), int(q))
                for e, g, q in zip(ext, grow, self.pad_quanta))

        need = float(np.prod(np.asarray(dims_for(1), np.float64)))
        if need > budget:
            raise StateSpaceError(
                f"FSP box extents {tuple(int(e) for e in ext)} exceed the "
                f"preallocation budget {budget:.3g} elements — use the "
                "compressed backend or raise PACMENSL_BOX_MEM_BUDGET.")
        headroom = float(os.environ.get("PACMENSL_BOX_HEADROOM", "8"))
        target = budget
        if headroom > 0:
            prev = float(np.prod(np.asarray(
                self._shape or [0], np.float64)))
            target = min(budget, max(need * headroom, prev))
        lo, hi = 1, int(max(ext)) + int(budget)
        while lo < hi:                      # largest C within target
            mid = (lo + hi + 1) // 2
            if float(np.prod(np.asarray(dims_for(mid), np.float64))) \
                    <= target:
                lo = mid
            else:
                hi = mid - 1
        dims = np.asarray(dims_for(lo), np.int64)
        if self._shape is not None:         # monotone: never shrink
            dims = np.maximum(dims, np.asarray(self._shape, np.int64))
        return tuple(int(d) for d in dims)

    def _build_once(self):
        box_bounds = self.constraints.derive_box_bounds(
            self.num_species, self.init_states)
        box_bounds = np.maximum(
            box_bounds, getattr(self, "_box_floor", 0))
        if self.extent_floor is not None:
            box_bounds = np.maximum(box_bounds, self.extent_floor - 1)
        self._box_bounds = box_bounds
        raw_shape = np.asarray(box_shape_from_bounds(box_bounds))

        init_ok = np.array(self.constraints.all_satisfied(self.init_states))
        if not init_ok.all():
            raise StateSpaceError(
                "initial states violate the FSP constraints: "
                f"{self.init_states[~init_ok].tolist()}")
        if (self.init_states < 0).any() or \
                (self.init_states > box_bounds[None, :]).any():
            raise StateSpaceError("initial states outside the box")

        # Capacity: keep the current allocation when the box still fits,
        # else round the new extents up the ladder (and mesh quanta) — or
        # water-fill the whole element budget when preallocating.
        if self._shape is None or \
                any(int(s) > c for s, c in zip(raw_shape, self._shape)):
            if self.prealloc_budget is not None:
                new_shape = self._prealloc_shape(raw_shape)
            else:
                new_shape = list(
                    max(_round_capacity(int(s), int(qi)), c)
                    for s, c, qi in zip(
                        raw_shape,
                        self._shape or (0,) * len(raw_shape),
                        self.pad_quanta))
                new_shape = tuple(new_shape)
            new_size = int(np.prod(np.asarray(new_shape, np.float64)))
            if new_size > MAX_BOX_ELEMS:
                raise StateSpaceError(
                    f"FSP box capacity {new_shape} = {new_size:.3g} states "
                    f"exceeds the box-backend budget ({MAX_BOX_ELEMS:.3g}; "
                    "env PACMENSL_MAX_BOX_ELEMS). The truncated set no "
                    "longer fits a dense box — use the compressed backend "
                    "(FspSolverMultiSinks(backend='ell')), tighten the "
                    "constraints, or raise the budget.")
            # embed the previous mask into the new capacity so the BFS
            # below restarts from the already-known reachable set
            if self._prev_mask is not None:
                prev = self._prev_mask
                if self.build_on_device:
                    pad = [(0, n - o, 0) for n, o in zip(
                        new_shape, prev.shape)]
                    self._prev_mask = lax.pad(prev, jnp.zeros((), bool),
                                              pad)
                else:
                    grown = np.zeros(new_shape, dtype=bool)
                    grown[tuple(slice(0, o) for o in prev.shape)] = prev
                    self._prev_mask = grown
            self._shape = new_shape
            self._mask_builder = self._make_mask_builder(new_shape)

        seed_np = np.ravel_multi_index(tuple(self.init_states.T),
                                       self._shape)   # C-order, padded
        bounds_np = np.asarray(self.constraints.bounds)
        if self._prev_mask is None and self._seed_mask_fn is not None:
            seeded = self._seed_mask_fn(self._shape)
            if seeded is not None:
                self._prev_mask = (jnp.asarray(seeded, bool)
                                   if self.build_on_device
                                   else np.asarray(
                                       jax.device_get(seeded), bool))
            self._seed_mask_fn = None       # one-shot
        if self._prev_mask is None:
            if self.build_on_device:
                self._prev_mask = jnp.zeros(self._shape, dtype=bool)
            else:
                self._prev_mask = np.zeros(self._shape, dtype=bool)
        t0 = time.perf_counter()
        if self.build_on_device:
            # One compiled program per capacity, run at device speed; with
            # preallocation the capacity never changes, so the whole
            # adaptive solve compiles the builder exactly once and each
            # epoch's rebuild is a few milliseconds of device work.  The
            # incremental seed (previous mask) makes the BFS converge in
            # O(bound growth) dilations instead of O(set diameter).
            mask, n, leaks = self._mask_builder(
                jnp.asarray(bounds_np), jnp.asarray(seed_np))
            self._mask = mask
            self._mask_host_cache = None      # lazy device_get
        else:
            # Host CPU backend: compiles are local and fast; the mask
            # ships to the default device once, as data.
            from ..sys.environment import local_cpu_device
            cpu = local_cpu_device()
            with jax.default_device(cpu):
                mask, n, leaks = self._mask_builder(
                    jax.device_put(bounds_np, cpu),
                    jax.device_put(seed_np, cpu))
        # ONE batched transfer: one host round-trip per build instead of
        # three
        n_h, leaks_h = jax.device_get((n, leaks))
        if not self.build_on_device:
            self._mask_host_cache = np.asarray(jax.device_get(mask))
            # Device copy (uncommitted, resharding-friendly) is created
            # lazily by the ``mask`` property.
            self._mask = None
        self._num_states = int(n_h)
        self._leaks = np.asarray(leaks_h, dtype=bool)
        ev = getattr(self, "events", None)
        if ev is not None:
            ev.add("MaskBFS", time.perf_counter() - t0)
        if not self._leaks.any():
            # keep only converged masks as future BFS seeds (a leaking
            # build repeats at larger capacity from the same seed)
            self._prev_mask = (self._mask if self.build_on_device
                               else self._mask_host_cache)

    def _make_mask_builder(self, shape):
        """One jitted program builds the whole mask (constraint check + BFS
        reachability closure + count + face-closure leak bits).  Compiled
        once per capacity; the constraint bounds and BFS seed are runtime
        arguments (the incremental seed mask is closed state refreshed per
        call via the ``_prev_mask`` attribute — passed as an argument), so
        every expansion epoch at fixed capacity reuses the executable."""
        shifts = tuple(tuple(int(v) for v in row) for row in self.stoich)
        track = self.track_reachability
        values_fn = self.constraints.values_fn
        S = self.num_species
        stoich = self.stoich
        # Safety cap only: the loop stops as soon as a dilation adds
        # nothing.  A shortest path can be longer than the box extents
        # (|s| = 2 moves under a capped axis zig-zag: reaching (5, 4) in
        # a 2M <-> D box bounded by M <= 8 takes 18 steps, sum(shape)
        # was 15), so only the state count bounds it.
        max_iters = int(np.prod(shape)) + 1

        def build_mask(bounds_arr, seed_flat_idx, prev_mask):
            coords = coord_grid(shape)
            ok_flat = jnp.all(values_fn(coords) <= bounds_arr[None, :],
                              axis=1)
            ok = ok_flat.reshape(shape)
            if track:
                seed = prev_mask.reshape(-1).at[seed_flat_idx].set(True)
                mask = _bfs_closure(seed.reshape(shape), ok, shifts,
                                    max_iters)
            else:
                mask = ok
            # Face-closure leaks: axis i leaks when a valid state on the
            # capacity face has a constraint-satisfying outward neighbor
            # (reference contract: outward flux must reach a sink, never
            # be truncated).
            mask_flat = mask.reshape(-1)
            leaks = []
            for i in range(S):
                grow_rs = [r for r in range(stoich.shape[0])
                           if stoich[r][i] > 0]
                if not grow_rs:
                    leaks.append(jnp.zeros((), bool))
                    continue
                on_face = coords[:, i] == (shape[i] - 1)
                leak = jnp.zeros((), bool)
                for r in grow_rs:
                    s_r = jnp.asarray(stoich[r], coords.dtype)
                    tgt = coords + s_r[None, :]
                    ok_t = jnp.all(values_fn(tgt) <= bounds_arr[None, :],
                                   axis=1) & jnp.all(tgt >= 0, axis=1)
                    leak = leak | jnp.any(mask_flat & on_face & ok_t)
                leaks.append(leak)
            return mask, mask.sum(), jnp.stack(leaks)

        jitted = jax.jit(build_mask)

        def call(bounds_arr, seed_flat_idx):
            return jitted(bounds_arr, seed_flat_idx,
                          jnp.asarray(self._prev_mask))

        return call

    def absorb_mask(self, mask_add) -> None:
        """OR an extra validity mask (same box shape, device bool) into
        the state set — the reorder rebuild unions the transposed old
        mask so previously-held states are members BY CONSTRUCTION even
        when the fresh BFS closure misses them (observed: 1800 of 14.9M
        on hog1p's t=168.6 rung).  Every absorbed state must satisfy the
        current constraints (callers pass masks built under tighter
        bounds)."""
        new_mask = jnp.logical_or(self.mask, jnp.asarray(mask_add))
        n = int(jax.device_get(new_mask.sum()))
        self._mask = new_mask
        self._mask_host_cache = None
        self._num_states = n
        self._prev_mask = (new_mask if self.build_on_device
                           else np.asarray(jax.device_get(new_mask)))

    # ------------------------------------------------------- expansion ---
    def set_bounds(self, new_bounds) -> None:
        """Grow constraint bounds and rebuild box+mask (reference
        SetShapeBounds + Expand).  Returns nothing; use :meth:`embed_old`
        to scatter an old solution into the new layout."""
        self.constraints = self.constraints.with_bounds(new_bounds)
        old_shape = self._shape
        self._build()
        if any(n < o for n, o in zip(self._shape, old_shape)):
            raise StateSpaceError("state space must not shrink on expansion")

    def embed_old(self, p_old: jnp.ndarray,
                  old_shape: Tuple[int, ...]) -> jnp.ndarray:
        """Zero-pad an old box-shaped array into the current (larger) box —
        the ``ExpandVec`` analogue (PetscWrap.cpp:26-56).  When the bound
        growth stayed within the allocated capacity this is the identity:
        the newly valid states already hold zeros under the old mask."""
        old_shape = tuple(old_shape)
        if old_shape == tuple(self._shape):
            return p_old
        pad = [(0, n - o, 0) for n, o in zip(self._shape, old_shape)]
        return lax.pad(p_old.reshape(old_shape),
                       jnp.zeros((), p_old.dtype), pad)

    # ---------------------------------------------------------- queries ---
    @property
    def mask_host(self) -> np.ndarray:
        """Host (numpy) copy of the validity mask — assembly-time queries
        read this instead of round-tripping through the device.  In
        device-build mode this is a lazy device_get, paid only by callers
        that genuinely need host data (initial-vector seeding, final
        distribution extraction, the shell-sink fallback)."""
        if self._mask_host_cache is None:
            self._mask_host_cache = np.asarray(jax.device_get(self._mask))
        return self._mask_host_cache

    def states(self) -> np.ndarray:
        """Enumerate valid states [num_states, S] (host, box order)."""
        return np.argwhere(self.mask_host).astype(np.int64)

    def state2index(self, states) -> np.ndarray:
        """Map states to their flat (C-order) box index; -1 for states
        outside the box or invalid under the mask (reference State2Index
        semantics: every enumerated member state must round-trip).

        NOTE: the flat index uses row-major (C) order to match
        ``jnp.reshape(-1)`` / ``np.argwhere`` conventions — unlike the
        mixed-radix *keys* of :mod:`..sys.indexing`, which keep the
        reference's first-axis-fastest layout.
        """
        states = np.atleast_2d(np.asarray(states, dtype=np.int64))
        shape = np.asarray(self._shape, dtype=np.int64)
        strides = np.concatenate(
            [np.cumprod(shape[::-1])[::-1][1:], [1]])
        inside = ((states >= 0) & (states < shape[None, :])).all(axis=1)
        keys = states @ strides
        mask_flat = self.mask_host.reshape(-1)
        out = np.full(keys.shape, -1, dtype=np.int64)
        out[inside] = np.where(mask_flat[keys[inside]], keys[inside], -1)
        return out

    def extract_valid(self, p_box: jnp.ndarray) -> np.ndarray:
        """Gather p at valid states, in :meth:`states` order (host).

        When the valid set is a minority of the capacity box, compact ON
        DEVICE first (static-size nonzero over the mask, C-order — the
        same order as the host boolean index) and fetch only the valid
        values: the device-to-host copy is bandwidth-bound, so fetching
        the whole padded box would move the padding too."""
        n = self.num_states
        n_box = int(np.prod(self._shape))
        if isinstance(p_box, jnp.ndarray) and n < 0.6 * n_box:
            idx = jnp.nonzero(self.mask.reshape(-1), size=n)[0]
            vals = jnp.take(p_box.reshape(-1), idx)
            return np.asarray(jax.device_get(vals))
        p = np.asarray(jax.device_get(p_box)).reshape(-1)
        return p[self.mask_host.reshape(-1)]
