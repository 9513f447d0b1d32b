"""General compressed state set (ELL backend).

Functional equivalent of the reference ``StateSetBase`` /
``StateSetConstrained`` (``src/StateSet/StateSetBase.cpp``,
``StateSetConstrained.cpp``): an explicit, insertion-ordered list of states
with

* ``add_states``    — deduplicating insert (reference ``AddStates``,
  StateSetBase.cpp:188-258),
* ``state2index``   — batch state->global-index lookup returning -1 for
  absent states (reference ``State2Index``, StateSetBase.cpp:309-343),
* ``expand``        — frontier BFS closure under the reaction shifts,
  filtered by constraints (reference ``Expand``,
  StateSetConstrained.cpp:132-221).

The reference implements the state->index map as a Zoltan distributed hash
table with rendezvous hashing.  Here the map is the native C++ hash
directory :class:`pacmensl_tpu.native.fastset.FastSet` (open addressing on
mixed-radix keys; numpy binary-search fallback without a toolchain):
lookups happen only at assembly time, never in the integrator hot loop, so
host-side data structures are the right tool (`SURVEY.md` §7 core
representation choices).

This backend exists for exact set-parity with the reference (BFS-reachable
states only) and for constraint shapes too sparse for the dense-box backend;
the box backend serves coordinate-bound (hyper-rectangle) shapes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..sys.errors import StateSpaceError
from ..sys import indexing
from ..native.fastset import FastSet, sub2ind_native
from .constraints import ConstraintSet

# Status codes (reference StateSetBase active/inactive bookkeeping)
ACTIVE = 1
INACTIVE = -1


class StateSet:
    """Insertion-ordered deduplicated set of integer states."""

    def __init__(self,
                 stoichiometry: np.ndarray,
                 constraints: ConstraintSet,
                 init_states=None,
                 use_native: bool = True):
        self.stoich = np.atleast_2d(np.asarray(stoichiometry, dtype=np.int64))
        self.constraints = constraints
        self.states = np.zeros((0, self.num_species), dtype=np.int64)
        self.status = np.zeros((0,), dtype=np.int8)
        self._use_native = use_native
        self._refresh_key_space()
        self._dir = FastSet()
        if init_states is not None:
            self.add_states(init_states)

    # ------------------------------------------------------------ basics
    @property
    def num_species(self) -> int:
        return self.stoich.shape[1]

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    @property
    def num_states(self) -> int:
        return self.states.shape[0]

    @property
    def num_constraints(self) -> int:
        return self.constraints.num_constraints

    # --------------------------------------------------------- key space
    def _refresh_key_space(self):
        """(Re)derive the mixed-radix key bounds from the constraint box.

        Key bounds must cover every state that can ever be probed (members
        and their +/- stoichiometry neighbours), so pad by the stoichiometry
        range.  The box probe can under-estimate for coordinate-coupled
        constraints (e.g. ``(x0==0)*(x1+x2) <= b``) — :meth:`add_states`
        grows the key space dynamically whenever an incoming state exceeds
        it, so the probe only seeds the initial size.
        """
        seed = self.states if self.states.size else \
            np.zeros((1, self.num_species), dtype=np.int64)
        box = self.constraints.derive_box_bounds(self.num_species, seed)
        pad = np.abs(self.stoich).max(axis=0) if self.stoich.size else 0
        prev = getattr(self, "_key_bounds", 0)
        self._key_bounds = self._checked_key_bounds(
            np.maximum(box + pad, prev))

    @staticmethod
    def _checked_key_bounds(box) -> np.ndarray:
        # int64 overflow guard
        prod = 1.0
        for b in box:
            prod *= float(b + 1)
        if prod >= 2.0 ** 62:
            raise StateSpaceError(
                "state key space exceeds int64; this constraint shape needs "
                "a wider key type (box bounds: %r)" % (box,))
        return np.asarray(box, dtype=np.int64)

    def _ensure_key_space(self, states: np.ndarray) -> None:
        """Grow the key space to cover ``states`` (+ stoichiometry pad).

        Out-of-range coordinates linearize to sub2ind's negative invalid
        codes, which the directory rejects — without this growth such
        states would be *silently dropped* from the BFS (observed as a
        0.9/s mass-conservation leak on hog1p_3d, whose gated constraints
        defeat the axis-ray box probe).  Growth rebuilds the directory
        (O(n), amortized by the 25% margin)."""
        if states.size == 0:
            return
        mx = states.max(axis=0)
        if (mx <= self._key_bounds).all():
            return
        pad = np.abs(self.stoich).max(axis=0) if self.stoich.size else 0
        need = mx + pad
        grown = np.maximum(self._key_bounds,
                           np.maximum(need, (need * 5) // 4 + 1))
        self._key_bounds = self._checked_key_bounds(grown)
        self._reindex()

    def _keys_of(self, states) -> np.ndarray:
        if self._use_native:
            return sub2ind_native(self._key_bounds, states)
        return indexing.sub2ind(self._key_bounds, states)

    def _reindex(self):
        """Rebuild the key directory (keys depend on the key-space bounds,
        so growth of the constraint box invalidates every key — the
        reference instead updates its Zoltan DD entries in place,
        StateSetBase.cpp:459-476; a rebuild is the same O(n) work)."""
        self._dir = FastSet(capacity_hint=max(2 * self.num_states, 1024))
        if self.num_states:
            self._dir.insert(self._keys_of(self.states))

    # ------------------------------------------------------------ insert
    def add_states(self, new_states) -> int:
        """Insert states (dedup against members and within the batch);
        returns the number actually added.  Invalid (constraint-violating
        or negative) states are rejected, mirroring the reference's BFS
        candidate filtering."""
        new_states = np.atleast_2d(np.asarray(new_states, dtype=np.int64))
        if new_states.shape[1] != self.num_species:
            raise StateSpaceError(
                f"states have {new_states.shape[1]} species, expected "
                f"{self.num_species}")
        ok = np.array(self.constraints.all_satisfied(new_states))
        ok &= (new_states >= 0).all(axis=1)
        new_states = new_states[ok]
        if new_states.size == 0:
            return 0
        self._ensure_key_space(new_states)

        # one directory pass dedupes within the batch AND against members
        # (the reference's DD probe -> update -> find round,
        # StateSetBase.cpp:188-258)
        keys = self._keys_of(new_states)
        fresh = self._dir.insert(keys)
        if not fresh.any():
            return 0
        new_states = new_states[fresh]
        self.states = np.concatenate([self.states, new_states], axis=0)
        self.status = np.concatenate(
            [self.status, np.full(new_states.shape[0], ACTIVE, np.int8)])
        return new_states.shape[0]

    # ------------------------------------------------------------ lookup
    def state2index(self, states) -> np.ndarray:
        """Global index of each state, or -1 if absent (reference
        State2Index)."""
        states = np.atleast_2d(np.asarray(states, dtype=np.int64))
        return self._dir.lookup(self._keys_of(states))

    # ------------------------------------------------------------ expand
    def expand(self, max_rounds: int = 1_000_000,
               old_bounds=None) -> int:
        """Frontier BFS closure: explore x + s_r from every unexplored
        state, filter by constraints, insert, repeat until no frontier
        remains (reference StateSetConstrained::Expand).  Returns the number
        of states added.

        ``old_bounds``: the constraint bounds the set was last closed
        under.  When given, the initial frontier shrinks to the *boundary
        states* — members with a successor that violated the old bounds
        but satisfies the new ones.  Any state new under the grown bounds
        is reachable only through such a previously-rejected transition,
        so the restricted seed is exact; it replaces a full candidate
        sweep (n*R hash probes) with R vectorized constraint evaluations
        (measured 3.9 s -> sub-second per epoch at 1.2M states).
        """
        # Constraint bounds may have grown since the last build: refresh the
        # key space and reactivate previously frozen states (reference
        # reactivates -1 states, StateSetConstrained.cpp:137-152).  The
        # directory stays incrementally current across add_states calls, so
        # the O(n) rebuild is needed only when the key bounds changed.
        old_kb = self._key_bounds.copy()
        self._refresh_key_space()
        if not np.array_equal(old_kb, self._key_bounds):
            self._reindex()
        self.status[:] = ACTIVE

        frontier = self.states
        if old_bounds is not None and self.num_states:
            old_b = np.asarray(old_bounds, dtype=np.int64).reshape(-1)
            new_b = self.constraints.bounds
            if old_b.shape == new_b.shape and (new_b >= old_b).all():
                seed = np.zeros(self.num_states, dtype=bool)
                for r in range(self.num_reactions):
                    tgt = self.states + self.stoich[r][None, :]
                    vals = np.asarray(self.constraints.values(tgt))
                    was_out = (vals > old_b[None, :]).any(axis=1)
                    now_in = (vals <= new_b[None, :]).all(axis=1) \
                        & (tgt >= 0).all(axis=1)
                    seed |= was_out & now_in
                frontier = self.states[seed]
        added_total = 0
        for _ in range(max_rounds):
            if frontier.shape[0] == 0:
                break
            # all reachable candidates from the frontier
            cands = (frontier[:, None, :] +
                     self.stoich[None, :, :]).reshape(-1, self.num_species)
            n_before = self.num_states
            self.add_states(cands)
            added = self.num_states - n_before
            added_total += added
            frontier = self.states[n_before:]
        return added_total

    def set_bounds(self, new_bounds) -> None:
        self.constraints = self.constraints.with_bounds(new_bounds)

    def reorder(self, perm) -> None:
        """Physically reorder the states to a new global ordering.

        Analogue of Zoltan auto-migration moving state columns between
        ranks (reference ``StatePartitionerBase.cpp:186-239``): here the
        ordering IS the layout (position = global index), so migration is
        a host-side permutation plus a directory rebuild; GSPMD moves the
        actual device data when the re-ordered operator is assembled.
        """
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape[0] != self.num_states:
            raise StateSpaceError(
                f"permutation length {perm.shape[0]} != num_states "
                f"{self.num_states}")
        self.states = np.ascontiguousarray(self.states[perm])
        self.status = self.status[perm]
        self._reindex()

    def copy_states(self) -> np.ndarray:
        """Reference CopyStatesOnProc."""
        return self.states.copy()
