"""Matrix-free dense-box CME operator.

Re-design of the reference operator stack (``FspMatrixBase`` +
``FspMatrixConstrained``, ``src/Matrix/*.cpp``) for an accelerator:

The reference assembles one sparse SELL matrix per time-varying reaction plus
a merged time-invariant matrix, and its matvec is bandwidth-bound on reading
matrix values + column indices (~2*8B + 4B per nonzero).  On an accelerator,
arithmetic is cheap relative to device-memory bandwidth, so this operator
stores **no matrix at all**: the action

    (A(t) p)_x = sum_r c_r(t) [ a_r(x - s_r) p(x - s_r) - a_r(x) p(x) ]

is computed by re-evaluating the propensities from the coordinate grid
(XLA fuses the iota-based coordinates into the elementwise graph — zero HBM
traffic) and turning the ``x -> x + s_r`` moves into static stencil shifts
of the dense box array.  Traffic per matvec drops from O((2R+1) * 8B * n)
to O(R reads of p + 1 write), and the shifts shard into neighbor
collective-permutes under GSPMD.

Sink rows (``FspMatrixConstrained::GenerateValues``,
FspMatrixConstrained.cpp:121-282): a transition x -> x + s_r leaving the
constraint set contributes a_r(x) to the sink of **every** constraint the
target violates (reference semantics, including multi-counting).  Here the
sink derivative is a fused masked reduction per reaction.

**Epoch-stable compilation.**  Everything that changes between FSP
expansion epochs at a fixed array capacity — the validity mask and the
constraint bounds — travels as the :class:`BoxOpData` argument of
:meth:`action`, never as a closed-over constant.  One compiled solve
program therefore serves every epoch until the capacity itself grows
(the reference instead destroys + regenerates its matrices every epoch,
FspSolverMultiSinks.cpp:168-171 — cheap for PETSc assembly, ruinous if it
forced an XLA recompile).

``materialize=True`` precomputes the per-reaction propensity fields instead
(one dense array per reaction) — the stored-operator variant for propensity
functions too expensive to recompute; it is the closest analogue of the
reference's stored SELL values.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..models.model import Model
from ..statespace.box_space import BoxStateSpace
from .stencil import shift_nd, coord_grid
from .vecops import FspVector


class BoxOpData(NamedTuple):
    """Per-epoch operator data (a jax pytree; jit *argument*, not constant).

    ``mask_f``: validity mask over the box, as floats.
    ``bounds``: constraint RHS vector (the sink thresholds).
    ``sink_idx``/``sink_val``/``sink_rid``: the **sink shell** — per
    constraint, the flat indices, masked propensity values, and (global)
    reaction ids of every transition leaving the constraint set.  Sink
    rows are supported only on the thin boundary shell of the truncated
    set, so the per-matvec sink derivative reduces over ``[n_c, m_pad]``
    arrays instead of dense [n, n_c] violation fields (the dense form
    cost more than the whole stencil).  ``m_pad`` is capacity-laddered so
    expansion epochs usually reuse compiled programs.
    """
    mask_f: jnp.ndarray
    bounds: jnp.ndarray
    sink_idx: jnp.ndarray   # [n_c, m_pad] int32 flat box indices
    sink_val: jnp.ndarray   # [n_c, m_pad] masked propensity a_r(x), 0 = pad
    sink_rid: jnp.ndarray   # [n_c, m_pad] int32 global reaction index


def _shell_ladder(n: int) -> int:
    c = 256
    while c < n:
        c = int(c * 3 / 2)
    return c


class BoxOperator:
    """Truncated CME generator on a :class:`BoxStateSpace`."""

    def __init__(self,
                 model: Model,
                 space: BoxStateSpace,
                 dtype=None,
                 materialize: bool = False,
                 enable_reactions: Optional[Sequence[int]] = None,
                 sink_m_floor: int = 0):
        self.model = model
        self.space = space
        self.dtype = dtype or DEFAULT_DTYPE
        self.materialize = materialize
        self.enable_reactions = tuple(
            enable_reactions if enable_reactions is not None
            else range(model.num_reactions))

        self.shape = space.shape
        self._n = int(np.prod(self.shape))
        self._values_fn = space.constraints.values_fn
        self._shifts = tuple(tuple(int(v) for v in row)
                             for row in model.stoichiometry)
        self._data: Optional[BoxOpData] = None
        self._shell_eval = None
        # Monotone sink-shell padding: the padded shell width only ever
        # grows (and callers pass the previous operator's value through
        # rebuilds), so within-capacity expansion epochs keep the shapes
        # of BoxOpData stable and downstream jitted programs compiled.
        self.sink_m_pad = int(sink_m_floor)
        self.refresh_data()

        if materialize:
            self._prop_fields = [self._propensity_field(r)
                                 for r in self.enable_reactions]
        else:
            self._prop_fields = None
        # Violation fields are always computed on the fly: storing them
        # would cost n * n_constraints per reaction, and they are pure
        # constraint-function evaluations that XLA fuses for free.

    # ------------------------------------------------------------- data
    def refresh_data(self) -> BoxOpData:
        """Snapshot the space's current mask + bounds into the operator
        data pytree (and rebuild the sink shell).  Call after every
        ``space.set_bounds`` (the driver does); shapes are
        capacity-stable up to sink-shell ladder growth, so downstream
        jitted programs usually keep their compiled executables."""
        # Assembly never touches the accelerator: the mask is cast
        # host-side and bounds stay numpy until the final asynchronous
        # host->device transfers below.
        bounds_np = np.asarray(self.space.constraints.bounds)
        sink_idx, sink_val, sink_rid = self._build_sink_shell(bounds_np)
        if getattr(self.space, "build_on_device", False):
            # device-built mask: stays on device end-to-end (no host cast)
            mask_f = self.space.mask.astype(jnp.dtype(self.dtype))
        else:
            mask_f = jnp.asarray(
                self.space.mask_host.astype(jnp.dtype(self.dtype)))
        self._data = BoxOpData(mask_f=mask_f, bounds=jnp.asarray(bounds_np),
                               sink_idx=sink_idx, sink_val=sink_val,
                               sink_rid=sink_rid)
        return self._data

    def _build_sink_shell(self, bounds):
        """Extract the boundary shell: per constraint c, every state x with
        ``x + s_r`` violating c contributes ``a_r(x)·mask(x)`` under
        reaction r (reference sink-row sparsity,
        FspMatrixConstrained.cpp:156-241 — the reference stores these as
        per-rank sequential sink matrices; here they are padded index/value
        arrays reduced on-device)."""
        n_c = self.num_constraints
        per_c = [[] for _ in range(n_c)]
        # Host-side extraction: one stable jitted evaluation per reaction
        # then pure numpy — a device-side compaction would compile a fresh
        # gather program per (reaction, constraint, count), every epoch.
        mask_np = self.space.mask_host.reshape(-1) != 0
        if self._shell_eval is None:
            # compiled for the LOCAL CPU backend (bounds are committed to
            # the cpu device, steering the jit): compiles are local and
            # fast, and the result is already host memory
            def shell_eval(r, bounds):
                return (self._violation_field(r, bounds) != 0,
                        self._propensity_field(r).reshape(-1))
            self._shell_eval = jax.jit(shell_eval, static_argnums=0)
        from ..sys.environment import local_cpu_device
        cpu = local_cpu_device()
        bounds_cpu = jax.device_put(np.asarray(bounds), cpu)
        for k, r in enumerate(self.enable_reactions):
            with jax.default_device(cpu):
                viol_r, prop_r = self._shell_eval(r, bounds_cpu)
            viol_np = np.asarray(viol_r)
            prop_np = np.asarray(prop_r)
            # shell = VALID states whose target x + s_r violates c (invalid
            # sources have a·mask = 0 and would only bloat the shell)
            viol = viol_np & mask_np[:, None]
            a_m = prop_np * mask_np
            for c in range(n_c):
                idx = np.nonzero(viol[:, c])[0]
                if idx.size == 0:
                    continue
                per_c[c].append((idx.astype(np.int32), a_m[idx],
                                 np.full(idx.size, r, np.int32)))
        m_max = max((sum(int(i.shape[0]) for i, _, _ in parts)
                     for parts in per_c), default=0)
        self.sink_m_pad = max(_shell_ladder(max(m_max, 1)), self.sink_m_pad)
        m_pad = self.sink_m_pad
        sink_idx = np.zeros((n_c, m_pad), np.int32)
        sink_val = np.zeros((n_c, m_pad), np.float64)
        sink_rid = np.zeros((n_c, m_pad), np.int32)
        for c, parts in enumerate(per_c):
            o = 0
            for idx, val, rid in parts:
                m = int(idx.shape[0])
                sink_idx[c, o:o + m] = idx
                sink_val[c, o:o + m] = val
                sink_rid[c, o:o + m] = rid
                o += m
        return (jnp.asarray(sink_idx), jnp.asarray(sink_val, self.dtype),
                jnp.asarray(sink_rid))

    def data(self) -> BoxOpData:
        return self._data if self._data is not None else self.refresh_data()

    @property
    def mask_f(self) -> jnp.ndarray:
        """Box-shaped validity mask, as floats."""
        return self.data().mask_f

    # ---------------------------------------------------------- assembly
    def _propensity_field(self, r: int) -> jnp.ndarray:
        """a_r over the box (unmasked).

        Coordinates are handed to the propensity in the operator's compute
        dtype, so a float32 operator keeps its model arithmetic in float32.
        """
        coords = coord_grid(self.shape).astype(self.dtype)
        a = jnp.asarray(self.model.propensity(coords, r), self.dtype)
        return a.reshape(self.shape)

    def _violation_field(self, r: int, bounds) -> jnp.ndarray:
        """[n, n_c] float: 1 where x + s_r violates constraint c
        (reference sink-row sparsity; FspMatrixConstrained.cpp:173-195)."""
        coords = coord_grid(self.shape)
        target = coords + jnp.asarray(
            self.model.stoichiometry[r], jnp.int32)[None, :]
        vals = self._values_fn(target)
        return (vals > jnp.asarray(bounds)[None, :]).astype(self.dtype)

    # ------------------------------------------------------------ action
    def action(self, t, y: FspVector,
               data: Optional[BoxOpData] = None) -> FspVector:
        """dy/dt = A(t) y  (jnp-traceable; the hot loop).

        Pass ``data`` explicitly inside jitted programs to keep them
        epoch-stable; without it the current snapshot is baked in as a
        constant (fine for one-shot uses).
        """
        if data is None:
            data = self.data()
        mask_f = data.mask_f
        p = y.p
        c = self.model.coefficients(t, self.dtype)

        dsinks = self._shell_sinks(p, c, data, y)

        inflow = jnp.zeros_like(p)
        outflow = jnp.zeros_like(p)
        for k, r in enumerate(self.enable_reactions):

            a_r = (self._prop_fields[k] if self._prop_fields is not None
                   else self._propensity_field(r)) * mask_f
            ap = a_r * p
            inflow = inflow + c[r] * shift_nd(ap, self._shifts[r])
            outflow = outflow + c[r] * ap
        dp = inflow * mask_f - outflow
        return FspVector(p=dp, sinks=dsinks)

    def _shell_sinks(self, p, c, data: BoxOpData, y: FspVector):
        """Sink derivative over the boundary shell: gather the few p
        entries adjacent to each constraint surface and reduce (reference
        sink matvec, FspMatrixConstrained.cpp:31-64)."""
        gathered = p.reshape(-1).at[data.sink_idx].get()

        return jnp.sum(data.sink_val * c[data.sink_rid] * gathered,
                       axis=1).astype(y.sinks.dtype)

    def __call__(self, t, y, data=None):
        return self.action(t, y, data)

    def diagonal(self, t=0.0, data: Optional[BoxOpData] = None
                 ) -> jnp.ndarray:
        """diag(A(t)) = -sum_r c_r(t) a_r(x), masked (used by the
        stationary solver's rank-one completion)."""
        if data is None:
            data = self.data()
        mask_f = data.mask_f
        c = self.model.coefficients(t, self.dtype)
        out = jnp.zeros(self.shape, self.dtype)
        for k, r in enumerate(self.enable_reactions):
            a_r = (self._prop_fields[k] if self._prop_fields is not None
                   else self._propensity_field(r)) * mask_f
            out = out - c[r] * a_r
        return out

    # ------------------------------------------------------------- misc
    @property
    def num_constraints(self) -> int:
        return self.space.num_constraints

    def zero_vector(self) -> FspVector:
        return FspVector(p=jnp.zeros(self.shape, self.dtype),
                         sinks=jnp.zeros((self.num_constraints,), self.dtype))

    def local_mv_flops(self) -> float:
        """FLOP estimate per matvec (reference GetLocalMVFlops,
        FspMatrixBase.cpp:429-444): ~2 flops per nonzero; here counted on
        the padded box (the work actually done)."""
        R = len(self.enable_reactions)
        return float(2 * (2 * R + 1) * self._n)

    def nnz(self) -> int:
        """Structural nonzeros of the equivalent sparse operator (for
        nnz/s benchmarking parity with the reference)."""
        n_valid = self.space.num_states
        return (len(self.enable_reactions) + 1) * n_valid
