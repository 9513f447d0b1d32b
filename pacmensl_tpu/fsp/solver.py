"""FspSolverMultiSinks: the transient FSP driver.

Rebuild of the reference driver
(``src/Fsp/FspSolverMultiSinks.{h,cpp}``): owns the constrained state space,
the CME operator, and an ODE backend, and runs the FSP
solve -> check-sinks -> expand -> scatter -> resume loop
(``Advance_``, FspSolverMultiSinks.cpp:62-224).

Key mappings (reference -> here):
  * ``CheckFspTolerance_`` (:576-611) -> an on-device per-sink stop-check
    traced into the integrator; expansion flags come back as the running
    max of per-sink excesses (SolveResult.viol_excess).
  * state-space expansion + Zoltan repartition -> bound growth + mask/BFS
    rebuild (box backend) or host frontier BFS (ELL backend).
  * ``ExpandVec`` solution scatter (PetscWrap.cpp:26-56) -> zero-pad
    embedding (box) / index scatter (ELL).
  * PETSc event logging -> :class:`~pacmensl_tpu.sys.events.EventLog`
    with the same phase names.

The ODE backend re-jits per expansion epoch (array shapes change), exactly
mirroring the reference's matrix destroy + regenerate per expansion.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import DEFAULT_DTYPE
from ..models.model import Model
from ..sys.errors import SetupError, IntegratorError, StateSpaceError
from ..sys.events import (EventLog, StepTrace, EVT_SETUP, EVT_PARTITION,
                          EVT_MATGEN, EVT_ODESOLVE, EVT_RHS, EVT_SCATTER,
                          EVT_TOTAL)
from ..sys.options import Options
from ..statespace.constraints import ConstraintSet
from ..statespace.box_space import BoxStateSpace
from ..statespace.state_set import StateSet
from ..statespace.partitioner import PartitioningType, PartitioningApproach
from ..ops.box_operator import BoxOperator
from ..ops.ell_operator import EllOperator
from ..ops.vecops import FspVector
from ..solvers.base import (ODESolverType, STATUS_OK, STATUS_FSP_STOP,
                            STATUS_CONTINUE)
from ..solvers.krylov import KrylovSolver
from ..solvers.rk import RKSolver
from ..solvers.bdf import BdfSolver
from .distribution import DiscreteDistribution


def _hbm_note() -> str:
    """Short device-memory string for verbose telemetry (empty when the
    backend exposes no stats — e.g. CPU)."""
    try:
        st = jax.devices()[0].memory_stats()
        used = st.get("bytes_in_use")
        lim = st.get("bytes_limit")
        if used is None:
            return ""
        s = f"  hbm={used/2**30:.2f}G"
        return s + (f"/{lim/2**30:.1f}G" if lim else "")
    except Exception:
        return ""


@partial(jax.jit, static_argnums=2)
def _scatter_into(p, dest, n):
    """p[i] -> out[dest[i]] in a zero vector of length n; out-of-range
    destinations are dropped."""
    return jnp.zeros((n,), p.dtype).at[dest].set(p, mode="drop")


class FspSolverMultiSinks:
    """Transient CME solver with multi-sink adaptive FSP truncation."""

    def __init__(self,
                 backend: str = "auto",
                 partitioning: PartitioningType = PartitioningType.BLOCK,
                 odes_type: Union[ODESolverType, str] = "auto",
                 mesh=None,
                 dtype=None,
                 preallocate: bool = False):
        self.backend = backend
        self.mesh = mesh
        #: eager box-capacity allocation for adaptive solves (see
        #: _build_space)
        self.preallocate = preallocate
        self.set_load_balancing_method(partitioning)
        self.repart_approach = PartitioningApproach.FROMSCRATCH
        #: re-balance only when the state set grew by this factor since the
        #: last partition (reference lb_threshold_/20% growth trigger,
        #: StateSetBase.h:111 + StateSetConstrained.cpp:213-218)
        self.lb_threshold = 1.2
        self.set_odes_type(odes_type)
        #: None = the library default (float64, the reference's precision)
        self.dtype = dtype

        self.model: Optional[Model] = None
        self.constraints: Optional[ConstraintSet] = None
        self._init_states: Optional[np.ndarray] = None
        self._init_probs: Optional[np.ndarray] = None
        # None = dtype-aware solver defaults (f64: reference values;
        # f32: loosened to what the precision can resolve)
        self.ode_rtol: Optional[float] = None
        self.ode_atol = 1.0e-14
        self.krylov_dim_range = (25, 60)
        self.krylov_abs_tol: Optional[float] = None
        self.verbosity = 0
        self.log_events = True
        self.events = EventLog(enabled=True)
        self.step_trace = StepTrace()

        self._space = None          # BoxStateSpace or StateSet
        self._operator = None
        self._y: Optional[FspVector] = None
        self._t_now = 0.0
        self._set_up = False
        self.sinks_: Optional[np.ndarray] = None

    # ---------------------------------------------------------- settings
    def set_model(self, model) -> "FspSolverMultiSinks":
        self.model = model
        return self

    def set_constraints(self, fn, bounds, expansion_factors=None
                        ) -> "FspSolverMultiSinks":
        """Custom constraint function + bounds (reference
        SetConstraintFunctions + SetInitialBounds)."""
        ns = self.model.num_species if self.model is not None else None
        self.constraints = ConstraintSet(fn, bounds, expansion_factors, ns)
        self._set_up = False
        return self

    def set_constraint_functions(self, fn) -> "FspSolverMultiSinks":
        """Set only the constraint function, keeping bounds if present
        (reference SetConstraintFunctions; call before set_initial_bounds
        when the custom constraint count differs from the species count)."""
        if self.constraints is not None:
            self.constraints = ConstraintSet(
                fn, self.constraints.bounds,
                self.constraints.expansion_factors)
        else:
            self._pending_constraint_fn = fn
        self._set_up = False
        return self

    def set_initial_bounds(self, bounds) -> "FspSolverMultiSinks":
        """Default (coordinate-wise) constraints with the given bounds."""
        fn = getattr(self, "_pending_constraint_fn", None)
        if self.constraints is not None and self.constraints.fn is not None:
            fn = self.constraints.fn
        if fn is not None:
            factors = (self.constraints.expansion_factors
                       if self.constraints is not None and
                       len(self.constraints.expansion_factors) == len(bounds)
                       else None)
            self.constraints = ConstraintSet(fn, bounds, factors)
        else:
            ns = self.model.num_species if self.model is not None else None
            self.constraints = ConstraintSet(None, bounds, None, ns)
        self._set_up = False
        return self

    def set_expansion_factors(self, factors) -> "FspSolverMultiSinks":
        if self.constraints is None:
            raise SetupError("set bounds before expansion factors")
        self.constraints = ConstraintSet(
            self.constraints.fn, self.constraints.bounds, factors,
            self.constraints.num_species)
        return self

    def set_initial_distribution(self, x0, p0=None) -> "FspSolverMultiSinks":
        """Initial states + probabilities, or a DiscreteDistribution to
        restart from (reference SetInitialDistribution overloads)."""
        if isinstance(x0, DiscreteDistribution):
            self._init_states = np.atleast_2d(x0.states)
            self._init_probs = np.asarray(x0.p, dtype=np.float64)
            # restart adopts the snapshot's FSP bounds so its states fit
            if x0.bounds is not None and self.constraints is not None \
                    and len(x0.bounds) == len(self.constraints.bounds):
                self.constraints = self.constraints.with_bounds(
                    np.maximum(self.constraints.bounds, x0.bounds))
        else:
            self._init_states = np.atleast_2d(np.asarray(x0, dtype=np.int64))
            if p0 is None:
                raise SetupError("p0 required with explicit states")
            self._init_probs = np.asarray(p0, dtype=np.float64).reshape(-1)
        if self._init_probs.shape[0] != self._init_states.shape[0]:
            raise SetupError("x0/p0 length mismatch")
        self._set_up = False
        return self

    def set_odes_type(self, odes_type) -> "FspSolverMultiSinks":
        """Pick the integrator; ``"auto"`` (the default) resolves at setup
        to KRYLOV for time-invariant models and CVODE (BDF) for
        time-varying ones — the Krylov basis freezes c(t) per step
        (quantified in tests/test_krylov_tv.py), so tv models default to
        the integrator that re-evaluates c(t) inside the step, matching
        the reference's own default (FspSolverMultiSinks.h: CVODE)."""
        if isinstance(odes_type, str) and odes_type.strip().lower() == "auto":
            self.odes_type = "auto"
            return self
        self.odes_type = (odes_type if isinstance(odes_type, ODESolverType)
                          else ODESolverType.from_string(str(odes_type)))
        return self

    def _resolve_odes_type(self) -> ODESolverType:
        if self.odes_type != "auto":
            if self.odes_type in (ODESolverType.KRYLOV, ODESolverType.EPIC) \
                    and self.model is not None and self.model.tv_reactions:
                import warnings
                warnings.warn(
                    "KRYLOV on a time-varying model freezes c(t) at each "
                    "step's midpoint (measured TV error ~2e-4 on hog1p at "
                    "t=180, tests/test_krylov_tv.py); use CVODE for tight "
                    "tolerances", RuntimeWarning, stacklevel=3)
            return self.odes_type
        return (ODESolverType.CVODE
                if self.model is not None and self.model.tv_reactions
                else ODESolverType.KRYLOV)

    def set_ode_tolerances(self, rtol, atol) -> "FspSolverMultiSinks":
        self.ode_rtol = None if rtol is None else float(rtol)
        self.ode_atol = float(atol)
        return self

    def set_krylov_dim_range(self, m_min, m_max) -> "FspSolverMultiSinks":
        self.krylov_dim_range = (int(m_min), int(m_max))
        return self

    def set_ts_type(self, name: str) -> "FspSolverMultiSinks":
        """Pluggable TS method for the PETSC backend (reference
        TsFsp::SetTsType / -ts_type): 'rk' (explicit DP5(4)), 'cn'/
        'theta'/'trapezoid' (implicit trapezoid + matrix-free GMRES),
        'bdf'/'beuler' (adaptive implicit BDF)."""
        self.ts_type = str(name).strip().lower()
        self._ode_solver = None
        return self

    def set_load_balancing_method(self, ptype) -> "FspSolverMultiSinks":
        self.partitioning = (ptype if isinstance(ptype, PartitioningType)
                             else PartitioningType.from_string(str(ptype)))
        return self

    def set_repart_approach(self, approach) -> "FspSolverMultiSinks":
        """How re-balancing treats the existing ordering (reference
        ``PartitioningApproach``): FROMSCRATCH recomputes the locality
        ordering each rebalance; REPARTITION/REFINE keep it and only let
        the shard boundaries move (migration-cost-aware)."""
        self.repart_approach = (
            approach if isinstance(approach, PartitioningApproach)
            else PartitioningApproach.from_string(str(approach)))
        return self

    def set_verbosity(self, level: int) -> "FspSolverMultiSinks":
        self.verbosity = int(level)
        return self

    def set_mesh(self, mesh) -> "FspSolverMultiSinks":
        """Shard the state axis over a 1-D device mesh (the analogue of
        running the reference on multiple MPI ranks)."""
        self.mesh = mesh
        self._set_up = False
        return self

    def set_from_options(self, opts: Optional[Options] = None
                         ) -> "FspSolverMultiSinks":
        """PETSc-style flag parsing (reference SetFromOptions,
        FspSolverMultiSinks.cpp:523-574)."""
        opts = opts or Options.from_argv()
        if opts.has("fsp_partitioning_type"):
            self.set_load_balancing_method(opts.get("fsp_partitioning_type"))
        if opts.has("fsp_repart_approach"):
            self.set_repart_approach(opts.get("fsp_repart_approach"))
        if opts.has("fsp_verbosity"):
            self.verbosity = opts.get_int("fsp_verbosity")
        if opts.has("fsp_log_events"):
            self.log_events = opts.get_bool("fsp_log_events")
        if opts.has("fsp_odes_type"):
            self.set_odes_type(opts.get("fsp_odes_type"))
        if opts.has("ts_type"):
            self.set_ts_type(opts.get("ts_type"))
        if opts.has("fsp_backend"):
            self.backend = opts.get("fsp_backend")
        if opts.has("ode_rtol") or opts.has("ode_atol"):
            self.set_ode_tolerances(opts.get_float("ode_rtol", self.ode_rtol),
                                    opts.get_float("ode_atol", self.ode_atol))
        return self

    # -------------------------------------------------------------- setup
    def _box_elem_budget(self) -> float:
        """Box-backend element budget derived from the vector-memory
        budget: the integrator keeps many box-shaped vectors alive
        (Krylov: m_max + 2 basis/work vectors), so usable box capacity is
        budget_bytes / (live_vectors * itemsize).  Overridable via
        PACMENSL_BOX_MEM_BUDGET (bytes)."""
        import os
        mem = float(os.environ.get("PACMENSL_BOX_MEM_BUDGET", 8.0e9))
        odes = self._resolve_odes_type()
        if odes in (ODESolverType.KRYLOV, ODESolverType.EPIC):
            vecs = self.krylov_dim_range[1] + 2
        else:
            # BDF: GMRES basis (restart+1) + Nordsieck history (q_max+3)
            # + predictor/corrector work vectors (+ safety margin; 16 was
            # measured 2.2 GB short on a 125M-element hog1p box: XLA
            # 'Used 17.93G of 15.75G hbm')
            from ..solvers.bdf import BdfSolver
            restart = BdfSolver.__init__.__kwdefaults__["gmres_restart"]
            vecs = restart + 1 + 8 + 11
        return mem / (vecs * np.dtype(self.dtype).itemsize)

    def _choose_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        # Custom constraint shapes (products/sums, e.g. repressilator's
        # x_i * x_j <= b) would pay box-volume work for fill-fraction
        # states, so they take the compressed backend; coordinate bounds
        # take the dense box while it fits the vector-memory budget.  The
        # solve migrates itself to the compressed backend mid-flight if
        # expansion outgrows the budget or fill collapses
        # (_should_leave_box).  These thresholds are not yet derived from
        # measurements on the GPU (ROADMAP S2-S6).
        if self.constraints.fn is not None:
            return "ell"
        box_bounds = self.constraints.derive_box_bounds(
            self.model.num_species, self._init_states)
        box_size = float(np.prod(np.asarray(box_bounds, np.float64) + 1))
        if box_size > min(2e8, self._box_elem_budget()):
            return "ell"
        return "box"

    def _should_leave_box(self, new_bounds) -> bool:
        """Decide, before a box-backend expansion, whether the solve must
        migrate to the compressed (ELL) backend: the grown bounding box
        would exceed the vector memory budget, or the constraint set has
        become so sparse in its box that gather wins over stencil."""
        if self._backend_used != "box":
            return False
        cs_new = self.constraints.with_bounds(new_bounds)
        box = cs_new.derive_box_bounds(self.model.num_species,
                                       self._init_int)
        from ..statespace.box_space import (_round_capacity, _round_fine,
                                            MAX_BOX_ELEMS)
        # FRESH-build estimate (no clamp to the current, possibly
        # headroom-inflated allocation): a capacity-outgrow event may
        # rebuild the space from scratch (_rebuild_box_reordered), which
        # resets the padding — so the box backend stays viable as long as
        # the minimum fresh capacity of the new bounds fits the budget.
        # (The old monotone estimate migrated hog1p at t=136 with 87%
        # box fill because its 8x-headroom capacity crossed the budget,
        # pushing a box-perfect problem onto the compressed backend.)
        rnd = (_round_fine if getattr(self._space, "prealloc_budget",
                                      None) is not None
               else _round_capacity)
        need = [rnd(int(b) + 1, int(q))
                for b, q in zip(box, self.pad_quanta_for_space())]
        cap = float(np.prod(np.asarray(need, np.float64)))
        if cap > min(float(MAX_BOX_ELEMS), self._box_elem_budget()):
            return True
        # Fill collapse: conservation laws / gated shapes can make the
        # reachable set a sliver of its bounding box, and the compressed
        # backend then does less work per matvec.  The 0.1% floor is
        # inherited and not yet re-derived from GPU per-element costs
        # (ROADMAP S2-S6).  Fill is measured against the TIGHT box of
        # the CURRENT bounds (not headroom-padded capacity, not the
        # post-expansion box).
        fill_floor = float(os.environ.get("PACMENSL_BOX_FILL_FLOOR",
                                          "0.001"))
        tight_new = float(np.prod(np.asarray(box, np.float64) + 1.0))
        box_cur = self.constraints.derive_box_bounds(
            self.model.num_species, self._init_int)
        tight_cur = float(np.prod(np.asarray(box_cur, np.float64) + 1.0))
        n = self._space.num_states
        return tight_new > 2.0e6 and n < fill_floor * tight_cur

    def _box_reorder_needed(self, new_bounds) -> bool:
        """True when the grown bounds outgrow the box capacity AND either
        (a) the extents are no longer in descending internal order, or
        (b) the monotone same-order regrowth would overflow the element
        budget while a FRESH build fits — the rebuild then sheds the
        earlier rungs' headroom padding."""
        if self._backend_used != "box":
            return False
        from ..statespace.permute import choose_axis_order
        from ..statespace.box_space import (_round_capacity, _round_fine,
                                            MAX_BOX_ELEMS)
        box = self.constraints.with_bounds(new_bounds).derive_box_bounds(
            self.model.num_species, self._init_int)
        ext = np.asarray(box, np.int64) + 1
        if all(int(e) <= int(c) for e, c in zip(ext, self._space.shape)):
            return False        # within capacity: no rebuild, no concern
        if choose_axis_order(ext) is not None:
            return True
        quanta = self.pad_quanta_for_space()
        budget = min(float(MAX_BOX_ELEMS), self._box_elem_budget())
        rnd = (_round_fine if getattr(self._space, "prealloc_budget",
                                      None) is not None
               else _round_capacity)
        clamped = [max(rnd(int(e), int(q)), int(c))
                   for e, q, c in zip(ext, quanta, self._space.shape)]
        fresh = [rnd(int(e), int(q))
                 for e, q in zip(ext, quanta)]
        return (float(np.prod(np.asarray(clamped, np.float64))) > budget
                >= float(np.prod(np.asarray(fresh, np.float64))))

    def _reorder_prep(self, new_bounds):
        """Shared reorder-rebuild front half: slice old device arrays to
        the old extents, compute the old->new transpose axes, restore
        user constraints, and rebuild the space under the fresh order
        (with the old extents as a floor so the new box embeds the old).

        Returns ``(transform, sinks_old)`` where ``transform(arr_box)``
        maps an old-layout box array onto the new layout entirely on
        device (slice -> transpose -> pad)."""
        from ..statespace.permute import choose_axis_order
        space_old = self._space
        S = self.model.num_species
        E1 = np.asarray(space_old._box_bounds, np.int64) + 1
        inv1 = getattr(self, "_axis_inv", None)
        o1 = (self._axis_order if inv1 is not None
              else np.arange(S, dtype=np.int64))
        inv1 = np.argsort(o1)
        E1_user = E1[inv1]
        user_cs = (self._user_constraints if getattr(
            self, "_axis_inv", None) is not None else self.constraints)
        self.constraints = user_cs.with_bounds(new_bounds)
        box_u = self.constraints.derive_box_bounds(S, self._init_states)
        o2 = choose_axis_order(np.asarray(box_u) + 1)
        if o2 is None:
            o2 = np.arange(S, dtype=np.int64)
        floor_new = E1_user[o2]
        old_mask = space_old.mask          # device bool, old layout
        sinks_old = self._y.sinks

        # transpose axes: new internal axis j <- old internal axis t[j]
        t = tuple(int(inv1[int(u)]) for u in o2)

        def _seed_mask(shape_new):
            # previous reachable set, transposed into the new layout —
            # seeds the fresh build's BFS so it converges in a few
            # dilations instead of ~set-diameter passes over the box
            v = old_mask[tuple(slice(0, int(e)) for e in E1)]
            v = jnp.transpose(v, axes=t)
            pad = [(0, int(shape_new[j]) - int(E1[t[j]]), 0)
                   for j in range(S)]
            return lax.pad(v, jnp.zeros((), bool), pad)

        self._build_space_floor = floor_new
        try:
            # re-derives the same order o2
            self._build_space(seed_mask_fn=_seed_mask)
        finally:
            self._build_space_floor = None
        C2 = self._space.shape

        def transform(arr_box):
            v = arr_box[tuple(slice(0, int(e)) for e in E1)]
            v = jnp.transpose(v, axes=t)
            pad = [(0, int(C2[j]) - int(E1[t[j]]), 0) for j in range(S)]
            return lax.pad(v, jnp.zeros((), v.dtype), pad)

        # union the old membership in: the fresh BFS closure can miss
        # path-dependent states (observed: 1800 of 14.9M on hog1p's
        # t=168.6 rung); the transposed old mask makes coverage exact
        self._space.absorb_mask(transform(old_mask))
        return transform, sinks_old

    def _rebuild_box_reordered(self, new_bounds, n_before,
                               to_expand) -> None:
        """Rebuild the box space/operator under a fresh axis order and
        carry the solution over ON DEVICE: state identity = coordinates,
        so the old box embeds into the new one as slice -> transpose ->
        zero-pad (the host state-identity scatter this replaces cost
        minutes at 15-23M states on hog1p)."""
        if self.verbosity:
            print(f"[fsp] t = {self._t_now:.4g}: re-deriving box axis "
                  "order at capacity growth")
        p_dev = self._y.p
        floor = getattr(self._operator, "sink_m_pad", 0)
        with self.events.timed(EVT_MATGEN):
            transform, sinks_old = self._reorder_prep(new_bounds)
            self._escalate_if_stuck(n_before, to_expand)
            self._operator = None
            self._build_operator()
            if self._operator.sink_m_pad < floor:
                self._operator.sink_m_pad = floor
        with self.events.timed(EVT_SCATTER):
            p = transform(p_dev)
            self._y = self._place(FspVector(p=p, sinks=sinks_old))
        self._ode_solver = None

    def pad_quanta_for_space(self) -> np.ndarray:
        pad_quanta = np.ones(self.model.num_species, np.int64)
        if self.mesh is not None:
            pad_quanta[0] = self.mesh.devices.size
        return pad_quanta

    def _migrate_box_to_ell(self) -> None:
        """Switch a running box-backend solve to the compressed backend,
        carrying over the current state set and solution.  The reference
        has no analogue (its representation never changes); here it is
        the safety valve that keeps the fast dense path the default
        without risking OOM on pathologically sparse/unbounded shapes."""
        if self.verbosity:
            print(f"[fsp] t = {self._t_now:.4g}: box exceeds budget/fill "
                  "threshold, migrating to the compressed backend")
        states = self._space.states()               # current valid states
        p_dev = self._y.p
        p_vals = self._space.extract_valid(p_dev)   # host, states() order
        sinks_old = np.asarray(jax.device_get(self._y.sinks))
        # Drop every box-phase device reference (solution vector, space
        # masks, operator data) and the jit executables that captured
        # them, THEN build the compressed backend: the box phase leaves
        # tens-of-millions-element buffers plus per-capacity compiled
        # programs on the device, which the compressed phase would
        # otherwise have to fit beside.  Recompiles after the clear are
        # absorbed by the persistent compile cache.
        self._y = None
        self._space = None
        self._operator = None
        self._ode_solver = None
        p_dev = None
        jax.clear_caches()
        self._backend_used = "ell"
        if getattr(self, "_axis_inv", None) is not None:
            # leave the box's internal species order: the ELL backend
            # works in user order (no layout concerns there)
            states = states[:, self._axis_inv]
            self.constraints = self._user_constraints.with_bounds(
                self.constraints.bounds)
            self._int_model = None
            self._int_init = None
            self._axis_inv = None
        self._space = StateSet(self.model.stoichiometry, self.constraints,
                               init_states=states)
        self._space.expand()
        self._maybe_partition(force=True)
        self._operator = None        # built lazily by the expand flow
        self._ode_solver = None
        idx = self._space.state2index(states)
        order = np.argsort(idx)
        # solution as a flat [n] vector in insertion order (the ELL expand
        # scatter below re-maps it into the padded layout)
        self._y = FspVector(p=jnp.asarray(p_vals[order], self.dtype),
                            sinks=jnp.asarray(sinks_old, self.dtype))

    def set_up(self) -> "FspSolverMultiSinks":
        if self.model is None:
            raise SetupError("SetUp called before model was set")
        if self.constraints is None:
            raise SetupError("SetUp called before bounds were set")
        if self._init_states is None:
            raise SetupError("SetUp called before initial distribution")
        if self._init_states.shape[1] != self.model.num_species:
            raise SetupError("initial states do not match model species")
        if self.dtype is None:
            self.dtype = DEFAULT_DTYPE

        with self.events.timed(EVT_SETUP):
            self._backend_used = self._choose_backend()
            with self.events.timed(EVT_PARTITION):
                self._build_space()
            with self.events.timed(EVT_MATGEN):
                self._build_operator()
            self._y = self._initial_vector()
        self._set_up = True
        return self

    @property
    def _model_int(self):
        """Model in the box backend's internal species order (see
        :mod:`..statespace.permute`); the user's model elsewhere."""
        return getattr(self, "_int_model", None) or self.model

    @property
    def _init_int(self):
        return (self._int_init if getattr(self, "_int_init", None)
                is not None else self._init_states)

    def _setup_axis_order(self):
        """Reorder the box species axes by descending extent, so that the
        leading (shard) axis is the longest and the trailing dims stay
        large.  Ordering is free: box position is pure layout, and the
        reference's sparse rows have no analogue of this concern."""
        from ..statespace.permute import (choose_axis_order, permute_model,
                                          permute_constraints)
        if getattr(self, "_axis_inv", None) is not None:
            # un-permute a previous solve's internal constraint set so
            # re-setup never double-wraps the user callables
            self.constraints = self._user_constraints.with_bounds(
                self.constraints.bounds)
        self._int_model = None
        self._int_init = None
        self._axis_inv = None
        box_b = self.constraints.derive_box_bounds(
            self.model.num_species, self._init_states)
        order = choose_axis_order(np.asarray(box_b) + 1)
        if order is None:
            return
        self._axis_order = order
        self._axis_inv = np.argsort(order)
        self._user_constraints = self.constraints
        self._int_model = permute_model(self.model, order)
        self.constraints = permute_constraints(
            self.constraints, order, self.model.num_species)
        self._int_init = self._init_states[:, order]
        if self.verbosity:
            print(f"[fsp] box axis order (by extent): {order.tolist()}")

    def _build_space(self, extra_seeds=None, seed_mask_fn=None):
        """``extra_seeds``: additional BFS seed states in the (new)
        internal species order — the reorder rebuild passes the previous
        space's states so the fresh reachability closure provably covers
        them (and the box derives large enough to hold them).
        ``seed_mask_fn``: callable(shape) -> already-reachable mask at
        the new capacity (the reorder rebuild's transposed old mask),
        used as the first build's BFS seed."""
        if self._backend_used == "box":
            self._setup_axis_order()
            pad_quanta = None
            if self.mesh is not None:
                # make axis 0 divisible by the mesh size: it is the shard
                # axis (mesh.choose_shard_axis)
                pad_quanta = np.ones(self.model.num_species, np.int64)
                pad_quanta[0] = self.mesh.devices.size
            # Preallocation (opt-in): water-fill the vector-memory budget
            # as box capacity up-front and build masks on-device, so that
            # most expansion epochs reuse one compiled solve program.
            adaptive = bool(getattr(self, "_adaptive_hint", True)) and \
                bool((self.constraints.expansion_factors > 0).any())
            prealloc = None
            growable = None
            on_dev = False
            if self.preallocate and adaptive:
                from ..statespace.box_space import MAX_BOX_ELEMS
                prealloc = min(self._box_elem_budget(),
                               float(MAX_BOX_ELEMS))
                on_dev = True
                if self.constraints.fn is None:
                    growable = self.constraints.expansion_factors > 0
                else:
                    # custom constraints: an axis is growable iff growing
                    # every growable bound actually moves its box extent
                    # (e.g. hog1p's gene axis is capped at 3 by a
                    # zero-factor bound — water-filling it wastes an 8x
                    # slab of every vector)
                    cs = self.constraints
                    box1 = cs.derive_box_bounds(self.model.num_species,
                                                self._init_int)
                    grown = cs.with_bounds(cs.expanded_bounds(
                        cs.expansion_factors > 0))
                    box2 = grown.derive_box_bounds(self.model.num_species,
                                                   self._init_int)
                    growable = box2 > box1
            seeds = (self._init_int if extra_seeds is None
                     else np.vstack([self._init_int, extra_seeds]))
            self._space = BoxStateSpace(
                self._model_int.stoichiometry,
                self.constraints, seeds,
                pad_quanta=pad_quanta,
                prealloc_budget=prealloc,
                growable_axes=growable,
                build_on_device=on_dev,
                extent_floor=getattr(self, "_build_space_floor", None),
                seed_mask_fn=seed_mask_fn)
            if self.log_events:
                self._space.events = self.events   # MaskBFS sub-timer
        else:
            self._space = StateSet(self.model.stoichiometry,
                                   self.constraints,
                                   init_states=self._init_states)
            self._space.expand()
            self._maybe_partition(force=True)

    def _maybe_partition(self, force: bool = False) -> bool:
        """Dynamic load balancing of the compressed (ELL) state list.

        Reference semantics: ``StateSetConstrained::Expand`` re-partitions
        whenever the state count grew >20% since the last balance
        (``StateSetConstrained.cpp:213-218`` -> ``StatePartitioner::
        Partition``, ``StatePartitionerBase.cpp:36-67``).  Here a GRAPH/
        HYPERGRAPH partition means a bandwidth-reducing reordering of the
        state list (see :mod:`..statespace.partitioner`): a contiguous
        equal split of the reordered axis then has a thin boundary cut, so
        ``ShardedEllOperator``'s halo stays surface-sized.  Weighted
        boundaries degenerate to equal counts on this backend — every ELL
        row costs exactly R gather+FMA lanes regardless of how many
        neighbors exist, unlike the reference's variable-length sparse
        rows — and GSPMD requires equal shards anyway.

        The box backend's layout is structural (position = coordinates);
        partitioning does not apply, exactly as the reference's BLOCK
        layout of a dense enumeration would be a no-op.
        """
        if self._backend_used == "box":
            return False
        n = self._space.num_states
        last = getattr(self, "_n_last_partition", 0)
        if not force and n <= self.lb_threshold * last:
            return False
        self._n_last_partition = n
        ptype = self.partitioning
        if ptype == PartitioningType.BLOCK:
            return False         # insertion order IS the BLOCK layout
        n_parts = self.mesh.devices.size if self.mesh is not None else 1
        from ..statespace.partitioner import StatePartitioner
        part = StatePartitioner(ptype, self.repart_approach)
        prev = (np.arange(n)
                if self.repart_approach != PartitioningApproach.FROMSCRATCH
                else None)
        res = part.partition(self._space.states, self.model.stoichiometry,
                             n_parts, state2index=self._space.state2index,
                             prev_order=prev, need_boundaries=False)
        self._space.reorder(res.order)
        if self.verbosity:
            print(f"[fsp] re-partitioned {n} states "
                  f"({ptype.value}/{self.repart_approach.value})")
        return True

    def _build_operator(self):
        if self._backend_used == "box":
            # carry the sink-shell padding floor through rebuilds so the
            # shell arrays keep monotone shapes (fewer re-jits)
            floor = getattr(self._operator, "sink_m_pad", 0) \
                if self._operator is not None else 0
            self._operator = BoxOperator(self._model_int, self._space,
                                         dtype=self.dtype,
                                         sink_m_floor=floor)
            if self.verbosity:
                print(f"[fsp] box operator: capacity "
                      f"{tuple(self._space.shape)} "
                      f"({float(np.prod(self._space.shape)):.3g} elems)"
                      f"{_hbm_note()}", flush=True)
        elif self.mesh is not None:
            # explicit halo-exchange SpMV (the reference's VecScatter plan,
            # rebuilt per epoch like its matrices)
            from ..parallel.halo_ell import ShardedEllOperator
            self._operator = ShardedEllOperator(self.model, self._space,
                                                self.mesh, dtype=self.dtype)
        else:
            self._operator = EllOperator(self.model, self._space,
                                         dtype=self.dtype)
        self._log_halo_stats()
        self._ode_solver = None     # operator identity/shapes changed

    def _log_halo_stats(self):
        """Surface the exchange-plan size (values crossing between devices
        per matvec) in the event log — the observability analogue of the
        reference's VecScatter message counts."""
        comm = getattr(self._operator, "comm_values_per_matvec", None)
        if comm is not None and self.log_events:
            self.events.add_count("HaloValuesPerMatvec", int(comm()))

    def _initial_vector(self) -> FspVector:
        idx = self._space.state2index(
            self._init_int if self._backend_used == "box"
            else self._init_states)
        if (idx < 0).any():
            raise StateSpaceError(
                "initial states outside the FSP state space")
        n_c = self.constraints.num_constraints
        if self._backend_used == "box":
            p = np.zeros(self._space.size, dtype=np.float64)
            p[idx] = self._init_probs
            p = jnp.asarray(p, self.dtype).reshape(self._space.shape)
        else:
            p = np.zeros(self._operator.n_pad, dtype=np.float64)
            p[idx] = self._init_probs
            p = jnp.asarray(p, self.dtype)
        y = FspVector(p=p, sinks=jnp.zeros((n_c,), self.dtype))
        self.sinks_ = np.zeros((n_c,), np.float64)
        return self._place(y)

    def _place(self, y: FspVector) -> FspVector:
        if self.mesh is None:
            return y
        from ..parallel.mesh import shard_fsp_vector
        return shard_fsp_vector(y, self.mesh)

    # -------------------------------------------------------------- solve
    def _make_ode_solver(self, fsp_tol: float, t_final: float):
        n_sinks = self.constraints.num_constraints

        if fsp_tol > 0:
            def stop_check(t, y, forgiven):
                # reference CheckFspTolerance_ (FspSolverMultiSinks.cpp:
                # 576-611): sink_i exceeds its share of the tolerance
                # budget pro-rated by t/t_final.  ``forgiven`` subtracts
                # the excess already accumulated when the epoch started:
                # mass that reached a sink before an expansion can never
                # be reclaimed by growing the space, so re-tripping on it
                # would deadlock the solve/expand loop (expand, resume,
                # stop on the very first step, forever).  Only *new*
                # leakage beyond the pro-rated budget triggers a stop.
                excess = y.sinks * n_sinks - fsp_tol * (t / t_final)
                if forgiven is not None:
                    excess = excess - forgiven
                return excess
        else:
            stop_check = None

        odes = self._resolve_odes_type()
        if odes in (ODESolverType.KRYLOV, ODESolverType.EPIC):
            return KrylovSolver(self._operator.action,
                                abs_tol=self.krylov_abs_tol,
                                m_min=self.krylov_dim_range[0],
                                m_max=self.krylov_dim_range[1],
                                rhs_cost=self._operator.local_mv_flops(),
                                stop_check=stop_check, dtype=self.dtype)
        if odes == ODESolverType.CVODE:
            return BdfSolver(self._operator.action,
                             rtol=self.ode_rtol, atol=self.ode_atol,
                             stop_check=stop_check, dtype=self.dtype)
        if odes == ODESolverType.PETSC:
            # pluggable TS method (reference TsFsp accepts any -ts_type
            # and auto-wires the implicit machinery, TsFsp.cpp:227-274)
            ts = getattr(self, "ts_type", "rk")
            if ts in ("rk", "rk45", "dp5"):
                return RKSolver(self._operator.action,
                                rtol=self.ode_rtol, atol=self.ode_atol,
                                stop_check=stop_check, dtype=self.dtype)
            if ts in ("cn", "theta", "trapezoid"):
                from ..solvers.cn import CNSolver
                return CNSolver(self._operator.action,
                                rtol=self.ode_rtol, atol=self.ode_atol,
                                stop_check=stop_check, dtype=self.dtype)
            if ts in ("bdf", "beuler"):
                return BdfSolver(self._operator.action,
                                 rtol=self.ode_rtol, atol=self.ode_atol,
                                 stop_check=stop_check, dtype=self.dtype)
            raise SetupError(
                f"unknown ts_type {ts!r} (supported: rk, cn/theta/"
                "trapezoid, bdf/beuler)")
        raise SetupError(f"unsupported ODE solver type {odes}")

    def _expand(self, to_expand: np.ndarray, rounds: int = 1):
        """Grow flagged bounds, scatter the solution — and rebuild the
        operator only if the array capacity actually grew (reference
        Advance_ expansion block, :114-211; the reference rebuilds its
        matrices every time, but a PETSc re-assembly is milliseconds while
        an XLA recompile is seconds, so here bound growth within capacity
        only updates the operator *data*)."""
        def sync_note(tag):
            # verbosity>=2: device-order barrier + marker, to attribute
            # an asynchronous device fault to the phase that actually
            # dispatched the faulting program
            if self.verbosity >= 2:
                jnp.zeros(()).block_until_ready()
                print(f"[fsp-sync] {tag} ok", flush=True)

        new_bounds = self.constraints.expanded_bounds(to_expand)
        for _ in range(rounds - 1):      # escalated growth (thrash guard)
            new_bounds = self.constraints.with_bounds(
                new_bounds).expanded_bounds(to_expand)
        if self.verbosity:
            print(f"[fsp] t = {self._t_now:.4g}: expanding to bounds "
                  f"{new_bounds.tolist()}")
        with self.events.timed("LeaveBoxCheck"):
            leave = self._should_leave_box(new_bounds)
        if leave:
            with self.events.timed(EVT_PARTITION):
                self._migrate_box_to_ell()
        p_old, sinks_old = self._y.p, self._y.sinks
        n_before = self._space.num_states
        if self._backend_used == "box" and \
                self._box_reorder_needed(new_bounds):
            # anisotropic growth made the setup-time axis order stale (or
            # the monotone regrowth would overflow the budget): rebuild
            # the space in the fresh descending-extent order and scatter
            # the solution by state identity.  Only capacity
            # outgrowth triggers this — it pays the recompile anyway.
            with self.events.timed(EVT_PARTITION):
                self._rebuild_box_reordered(new_bounds, n_before,
                                            to_expand)
            if self.verbosity:
                print(f"[fsp] new state count: {self.num_states}"
                      f"{_hbm_note()}")
            return
        with self.events.timed(EVT_PARTITION):
            if self._backend_used == "box":
                old_shape = self._space.shape
                self._space.set_bounds(new_bounds)
                self.constraints = self._space.constraints
                self._escalate_if_stuck(n_before, to_expand)
                capacity_grew = tuple(self._space.shape) != tuple(old_shape)
            else:
                states_old = self._space.copy_states()
                bounds_old = self.constraints.bounds
                self._space.set_bounds(new_bounds)
                self.constraints = self._space.constraints
                self._space.expand(old_bounds=bounds_old)
                self._escalate_if_stuck(n_before, to_expand)
                self._maybe_partition()
                sync_note("ell-expand+partition")
        if self._backend_used != "box":
            # in-place re-assembly at laddered capacity: shapes (and hence
            # the compiled solve) survive most epochs; only ladder rungs
            # recompile (the reference pays a cheap PETSc re-assembly every
            # epoch, FspMatrixConstrained.cpp:121-282 — an XLA recompile is
            # NOT cheap, so capacity is padded geometrically)
            with self.events.timed(EVT_MATGEN):
                if self._operator is None:       # fresh after migration
                    self._build_operator()
                    capacity_grew = True
                else:
                    capacity_grew = self._operator.reassemble()
            sync_note("ell-matgen")
            if capacity_grew:
                self._ode_solver = None
        elif capacity_grew:
            with self.events.timed(EVT_MATGEN):
                self._build_operator()
            self._ode_solver = None     # shapes changed: re-jit
        else:
            with self.events.timed(EVT_MATGEN):
                self._operator.refresh_data()
        with self.events.timed(EVT_SCATTER):
            if self._backend_used == "box":
                if capacity_grew:
                    p_new = self._space.embed_old(p_old, old_shape)
                    self._y = self._place(
                        FspVector(p=p_new, sinks=sinks_old))
                # within capacity: p is already laid out correctly and the
                # newly valid states hold zeros (masked dynamics) — no
                # scatter at all.
            else:
                # ExpandVec analogue, entirely on device (PetscWrap.cpp:
                # 26-56): old entries land at their new global indices.
                # Fast path: with insertion order preserved (no GRAPH
                # reorder) old indices are the identity prefix, so the
                # scatter is a zero-pad — no host round-trip of p at all.
                idx = self._space.state2index(states_old)
                n_old = states_old.shape[0]
                n_pad = self._operator.n_pad
                if (idx == np.arange(n_old)).all():
                    pad = n_pad - int(p_old.shape[0])
                    p_new = jnp.pad(p_old, (0, pad)) if pad > 0 else p_old
                else:
                    # padding rows drop out of range: the program's shapes
                    # are the two capacities, not the state counts
                    dest = np.full(p_old.shape[0], n_pad, np.int64)
                    dest[:n_old] = idx
                    p_new = _scatter_into(p_old, jnp.asarray(dest), n_pad)
                self._y = self._place(FspVector(p=p_new, sinks=sinks_old))
        sync_note("scatter")
        if self.verbosity:
            print(f"[fsp] new state count: {self.num_states}"
                  f"{_hbm_note()}")

    def _escalate_if_stuck(self, n_before: int, to_expand) -> None:
        """If growing the flagged bounds added no states, grow *all*
        bounds until the space does grow.

        A flagged constraint's bound can be unreachable because other
        constraints cap it (e.g. a product constraint x_i * x_j capped by
        the coordinate bounds on x_i and x_j).  The reference has the same
        structural hazard — its sink rows multi-count a boundary
        transition into every violated constraint
        (FspMatrixConstrained.cpp:173-195) — and would grow the flagged
        bound forever without admitting a single new state.  Escalating to
        an all-constraint growth step restores progress while keeping the
        per-sink expansion semantics for the common case.
        """
        if self._space.num_states > n_before:
            return
        growable = self.constraints.expansion_factors > 0.0
        for _ in range(64):
            prev_bounds = self.constraints.bounds
            new_bounds = self.constraints.expanded_bounds(growable)
            self._space.set_bounds(new_bounds)
            self.constraints = self._space.constraints
            if self._backend_used != "box":
                self._space.expand(old_bounds=prev_bounds)
            if self._space.num_states > n_before:
                return
        raise StateSpaceError(
            "FSP expansion cannot add states: all growable bounds "
            f"exhausted (bounds={self.constraints.bounds.tolist()})")

    def _operator_data(self):
        """Epoch data passed through the integrator into the matvec (box
        backend); None for backends whose operators bake their arrays."""
        return (self._operator.data()
                if hasattr(self._operator, "data") else None)

    def _advance(self, t_final: float, fsp_tol: float) -> None:
        """The solve/check/expand loop (reference Advance_).

        Expansion escalation: the reference grows flagged bounds by a
        fixed factor per epoch (FspSolverMultiSinks.cpp:116-123), which at
        small t (where the pro-rated sink budget is near zero) causes long
        runs of epochs that advance time negligibly.  Those epochs cost
        the reference only a PETSc matrix rebuild, but cost this build an
        XLA recompile whenever array capacities change — so consecutive
        barely-progressing epochs compound the growth formula (up to 4x),
        collapsing the thrash phase.  The FSP truncation guarantee is
        growth-schedule independent."""
        t_start = self._t_now
        rapid = 0
        with self.events.timed(EVT_TOTAL):
            status = STATUS_FSP_STOP
            solver_key = (fsp_tol, t_final)
            if getattr(self, "_ode_solver_key", None) != solver_key:
                self._ode_solver = None
            while status == STATUS_FSP_STOP:
                if getattr(self, "_ode_solver", None) is None:
                    self._ode_solver = self._make_ode_solver(
                        fsp_tol, t_final)
                    self._ode_solver_key = solver_key
                    # new shapes -> per-matvec cost changed: re-measure
                    self._mv_budget = 0
                solver = self._ode_solver
                if fsp_tol > 0:
                    t_fg = time.perf_counter()
                    # already-lost sink mass beyond the pro-rated budget
                    # at epoch start — forgiven by the stop-check (see
                    # _make_ode_solver); zeros in the benign regime.
                    # The slack term keeps the resumed excess strictly
                    # negative: without it, a sink whose excess was exactly
                    # forgiven sits at 0 and compute-dtype rounding can
                    # re-trip the stop on the very first step, freezing t
                    # while expansion escalation inflates the space without
                    # bound (observed in f32 until device OOM).  The slack
                    # loosens the certified bound by at most 1e-3 * fsp_tol
                    # plus a few ulps of the sink scale.
                    n_sinks = self.constraints.num_constraints
                    # self.sinks_ is the host copy fetched in last epoch's
                    # batched read (expansion never changes sink mass);
                    # only a fresh solve pays a dedicated round-trip here
                    sinks_now = (np.asarray(self.sinks_, np.float64)
                                 if self.sinks_ is not None else
                                 np.asarray(jax.device_get(self._y.sinks),
                                            np.float64))
                    excess_now = (sinks_now * n_sinks -
                                  fsp_tol * (self._t_now / t_final))
                    eps = float(np.finfo(np.dtype(self.dtype)).eps)
                    slack = (64.0 * eps * np.maximum(np.abs(sinks_now)
                                                     * n_sinks, fsp_tol)
                             + 1.0e-3 * fsp_tol / n_sinks)
                    forgiven = jnp.asarray(
                        np.maximum(0.0, excess_now) + slack, self.dtype)
                    self.events.add("StopCheckPrep",
                                    time.perf_counter() - t_fg)
                else:
                    forgiven = None
                with self.events.timed(EVT_ODESOLVE):
                    # Adaptive per-dispatch matvec budget: one jitted
                    # solve call is one device dispatch, and bounded
                    # dispatches keep the host responsive (progress
                    # reports, wedge detection below).  Start small,
                    # measure the per-matvec wall of each dispatch, and
                    # size the next for ~PACMENSL_DISPATCH_TARGET_S
                    # seconds.
                    import os as _os
                    target_s = float(_os.environ.get(
                        "PACMENSL_DISPATCH_TARGET_S", "20"))

                    def dispatch(y, t0):
                        budget = int(getattr(self, "_mv_budget", 0)
                                     or 256)
                        tw = time.perf_counter()
                        r = solver.solve(y, t0, t_final,
                                         data=self._operator_data(),
                                         stop_aux=forgiven,
                                         mv_budget=budget)
                        st, nmv = (int(v) for v in jax.device_get(
                            (r.status, r.stats.n_matvecs)))
                        wall = time.perf_counter() - tw
                        rate = wall / max(nmv, 1)
                        cap = getattr(solver, "mv_per_dispatch", 1 << 30)
                        self._mv_budget = int(np.clip(
                            target_s / max(rate, 1e-7), 64, cap))
                        if self.verbosity >= 2:
                            print(f"[fsp-sync] integrate chunk "
                                  f"t={float(r.t):.4g} status={st} "
                                  f"nmv={nmv} wall={wall:.1f}s "
                                  f"next_budget={self._mv_budget}",
                                  flush=True)
                        return r, st

                    res, status = dispatch(self._y, self._t_now)
                    # budget exhausted: resume from (t, y); a resume
                    # that does not advance t is a wedged integrator
                    # and fails diagnosably instead
                    stalled = 0
                    t_res = float(res.t)
                    while status == STATUS_CONTINUE:
                        res, status = dispatch(res.y, t_res)
                        t_prev, t_res = t_res, float(res.t)
                        stalled = stalled + 1 if t_res <= t_prev else 0
                        if stalled >= 3:
                            raise IntegratorError(
                                f"integrator wedged at t = {t_res} "
                                "(3 consecutive zero-advance dispatch "
                                "budgets)")
                if status not in (STATUS_OK, STATUS_FSP_STOP):
                    raise IntegratorError(
                        f"ODE solver failed (status {status}) at "
                        f"t = {float(res.t)}")
                self._y = res.y
                self._t_now = float(res.t)
                # ONE batched device_get for everything the host reads per
                # epoch — sinks, step/matvec counts, the per-step trace
                # ring, and the violation flags: one host round-trip.
                fetch = {"sinks": res.y.sinks}
                if self.log_events:
                    # reference per-step logging OdeSolverBase.cpp:105-132
                    fetch["n_steps"] = res.stats.n_steps
                    fetch["n_mv"] = res.stats.n_matvecs
                    if res.trace is not None:
                        fetch["trace"] = (res.trace.t, res.trace.h,
                                          res.trace.aux)
                if status == STATUS_FSP_STOP:
                    fetch["viol"] = res.viol_excess
                with self.events.timed("HostFetch"):
                    host = jax.device_get(fetch)
                self.sinks_ = np.asarray(host["sinks"])
                if self.log_events:
                    self.step_trace.record_epoch(
                        int(host["n_steps"]), host.get("trace"),
                        self.num_states)
                    n_mv = int(host["n_mv"])
                    self.events.add_count(
                        EVT_RHS, n_mv,
                        flops=n_mv * self._operator.local_mv_flops())
                if status == STATUS_FSP_STOP:
                    viol = np.asarray(host["viol"])
                    to_expand = viol >= 0.0
                    if not to_expand.any():
                        to_expand[np.argmax(viol)] = True
                    t_before = getattr(self, "_t_prev_epoch", t_start)
                    if self._t_now - t_before < \
                            0.01 * max(t_final - t_start, 1e-300):
                        rapid += 1
                    else:
                        rapid = 0
                    self._t_prev_epoch = self._t_now
                    self._expand(to_expand, rounds=min(1 + rapid, 4))

    def solve(self, t_final: float, fsp_tol: float = 1.0e-4,
              t_init: float = 0.0) -> DiscreteDistribution:
        """Reference Solve (FspSolverMultiSinks.cpp:619-643)."""
        if not self._set_up:
            # a tol-0 (fixed-space) solve never expands: skip the eager
            # capacity preallocation and its oversized-box stencil work
            self._adaptive_hint = fsp_tol > 0
            self.set_up()
        self._y = self._initial_vector()
        self._t_now = float(t_init)
        self._advance(float(t_final), float(fsp_tol))
        return self._make_distribution()

    def solve_tspan(self, tspan: Sequence[float], fsp_tol: float = 1.0e-4,
                    t_init: float = 0.0) -> List[DiscreteDistribution]:
        """Reference SolveTspan: outputs at each time point, advancing
        segment by segment."""
        if not self._set_up:
            self._adaptive_hint = fsp_tol > 0
            self.set_up()
        self._y = self._initial_vector()
        self._t_now = float(t_init)
        out = []
        for t in tspan:
            self._advance(float(t), float(fsp_tol))
            out.append(self._make_distribution())
        return out

    def clear_state(self) -> None:
        self._set_up = False
        self._space = None
        self._operator = None
        self._ode_solver = None
        self._y = None

    # ------------------------------------------------------------ output
    @property
    def num_states(self) -> int:
        return self._space.num_states if self._space is not None else 0

    @staticmethod
    def _gather_global(arr) -> np.ndarray:
        """Host copy of a possibly cross-process-sharded array: a
        jax.distributed run's row-sharded solution spans non-addressable
        devices, so extraction all-gathers (the reference's final
        VecScatter to rank 0, FspSolverMultiSinks.cpp:719-731)."""
        if jax.process_count() > 1 and hasattr(arr, "is_fully_addressable") \
                and not arr.is_fully_addressable:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(
                arr, tiled=True))
        return np.asarray(jax.device_get(arr))

    def _make_distribution(self) -> DiscreteDistribution:
        with self.events.timed("DistributionExtract"):
            return self._make_distribution_impl()

    def _make_distribution_impl(self) -> DiscreteDistribution:
        if self._backend_used == "box":
            states = self._space.states()
            if getattr(self, "_axis_inv", None) is not None:
                states = states[:, self._axis_inv]   # back to user order
            p_dev = self._y.p
            if jax.process_count() > 1:
                p_host = self._gather_global(p_dev)
                p = p_host.reshape(-1)[self._space.mask_host.reshape(-1)]
            else:
                p = self._space.extract_valid(p_dev)
        else:
            states = self._space.copy_states()
            p = self._gather_global(self._y.p)[:states.shape[0]]
        return DiscreteDistribution(
            t=self._t_now, states=states, p=p,
            bounds=self.constraints.bounds.copy(),
            sinks=np.asarray(jax.device_get(self._y.sinks)))

    def get_event_log(self) -> EventLog:
        return self.events

    def reduce_component_timing(self):
        """Reference ReduceComponentTiming parity."""
        return self.events.reduce()

    # CamelCase aliases for users coming from the reference / pypacmensl
    SetModel = set_model
    SetInitialBounds = set_initial_bounds
    SetConstraintFunctions = set_constraint_functions
    SetExpansionFactors = set_expansion_factors
    SetInitialDistribution = set_initial_distribution
    SetOdesType = set_odes_type
    SetOdeTolerances = set_ode_tolerances
    SetKrylovDimRange = set_krylov_dim_range
    SetTsType = set_ts_type
    SetLoadBalancingMethod = set_load_balancing_method
    SetRepartApproach = set_repart_approach
    SetVerbosity = set_verbosity
    SetFromOptions = set_from_options
    SetUp = set_up
    Solve = solve
    SolveTspan = solve_tspan
    ClearState = clear_state
    ReduceComponentTiming = reduce_component_timing
