"""ELL-format gather-based CME operator (general/compressed backend).

Direct analogue of the reference's stored sparse operator
(``FspMatrixBase::GenerateValues``, ``src/Matrix/FspMatrixBase.cpp:76-251``):
every row (state) has at most one off-diagonal entry per reaction, so the
operator is naturally an ELL/SELL layout — exactly why the reference picked
PETSc MATMPISELL (FspMatrixBase.cpp:155).  Here the per-reaction column
indices and values are dense [n_pad] arrays and the matvec is a batched
gather — regular, static-shaped, and vmappable.

Used when the constraint set is too sparse inside its bounding box for the
dense stencil backend (see :mod:`box_operator`), or when propensities are
host-only callables that cannot trace into jit (they are evaluated once at
assembly, like the reference's ``PropFun`` callbacks).

Sink semantics identical to :class:`BoxOperator` / the reference: sinks
accumulate a_r(x) of every transition violating each constraint, stored as
packed bitmasks (one uint32 per state per reaction).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..models.model import Model
from ..statespace.state_set import StateSet
from .vecops import FspVector


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _capacity_ladder(n: int, quantum: int) -> int:
    """Padded capacity: the next rung of a 1.5x geometric ladder, in
    multiples of ``quantum``.  FSP expansion epochs at the same rung keep
    every array shape stable, so the jitted solve program is reused — the
    analogue of the reference's cheap PETSc re-assembly
    (FspMatrixConstrained.cpp:121-282) under XLA's static-shape rule."""
    c = quantum
    while c < n:
        c = _round_up(int(c * 3 / 2), quantum)
    return c


class EllOpData(NamedTuple):
    """Per-epoch operator arrays (a jax pytree; jit *argument*, never a
    closed-over constant — same epoch-stable-compilation design as
    :class:`~.box_operator.BoxOpData`).

    The ``offsets``/``bucket_delta``/``rem_*`` arrays drive the
    **bucket-shift gather** (see :meth:`EllOperator.action`), which
    replaces most of XLA's element gather with contiguous copies: after
    a locality ordering most rows' gather offset
    ``src_idx[i] - i`` takes one of a handful of values — those rows are
    served by ``jnp.roll`` (contiguous copies), and only the residue
    uses a real gather/scatter on a compacted list.  The bucket fields
    are left out of :meth:`EllOperator.data` in plain-gather mode (the
    default).
    """
    src_idx: jnp.ndarray    # [R, n_pad] int32 gather source per reaction
    off_val: jnp.ndarray    # [R, n_pad] off-diagonal a_r(x - s_r)
    diag_val: jnp.ndarray   # [R, n_pad] outflow a_r(x)
    sink_bits: jnp.ndarray  # [R, n_pad] uint32 packed violated-constraints
    offsets: jnp.ndarray      # [R, n_pad] int32 src_idx - row (0 on pad)
    bucket_delta: jnp.ndarray  # [R, K] int32 top-K offsets per reaction
    bucket_id: jnp.ndarray    # [R, n_pad] int8 bucket index (K = residue)
    rem_row: jnp.ndarray      # [M_pad] int32 destination rows (residue)
    rem_src: jnp.ndarray      # [M_pad] int32 gather sources
    rem_val: jnp.ndarray      # [M_pad] a_r(x - s_r) * c-index weight, 0 pad
    rem_rid: jnp.ndarray      # [M_pad] int32 reaction index


#: EllOpData fields only the bucket-shift gather reads
_BUCKET_FIELDS = ("offsets", "bucket_delta", "bucket_id", "rem_row",
                  "rem_src", "rem_val", "rem_rid")


class EllOperator:
    """Truncated CME generator over an explicit state list."""

    def __init__(self,
                 model: Model,
                 state_set: StateSet,
                 dtype=None,
                 pad_to: int = 128,
                 capacity_floor: int = 0,
                 enable_reactions: Optional[Sequence[int]] = None):
        self.model = model
        self.state_set = state_set
        self.dtype = dtype or DEFAULT_DTYPE
        self.enable_reactions = tuple(
            enable_reactions if enable_reactions is not None
            else range(model.num_reactions))
        self._pad_quantum = int(pad_to)
        self.n_states = state_set.num_states
        self.n_pad = max(_capacity_ladder(self.n_states, self._pad_quantum),
                         int(capacity_floor))
        self._assemble()

    def reassemble(self) -> bool:
        """Refresh the operator arrays after the state set changed
        (expansion epoch).  Returns True when the padded capacity had to
        grow — i.e. array shapes changed and downstream jitted programs
        must recompile; within-capacity epochs return False and reuse the
        compiled solve via the :meth:`data` pytree argument."""
        self.n_states = self.state_set.num_states
        grew = self.n_states > self.n_pad
        if grew:
            self.n_pad = _capacity_ladder(self.n_states, self._pad_quantum)
        old_buckets = self.bucket_static
        old_mode = self._gather_mode()
        self._assemble()
        # the gather mode and, in bucket mode, the static roll shifts are
        # baked into compiled programs: a change invalidates them like a
        # shape change
        mode = self._gather_mode()
        return grew or mode != old_mode or (
            mode == "bucket" and old_buckets != self.bucket_static)

    def _assemble(self):
        states = self.state_set.states            # [n, S] host
        n, n_pad = self.n_states, self.n_pad
        R = len(self.enable_reactions)
        n_c = self.state_set.num_constraints
        stoich = self.model.stoichiometry

        src_idx = np.zeros((R, n_pad), dtype=np.int32)
        off_val = np.zeros((R, n_pad), dtype=np.float64)
        diag_val = np.zeros((R, n_pad), dtype=np.float64)
        sink_bits = np.zeros((R, n_pad), dtype=np.uint32)

        # Assembly runs on the process-LOCAL CPU backend: propensity
        # sweeps over the state list are microseconds of vectorized math,
        # and each per-reaction device eval + device_get would be a
        # compile plus a host round-trip per epoch.  Mirrors the
        # reference, whose assembly is pure local CPU
        # (FspMatrixBase.cpp:76-251).  The sweeps run over the padded
        # capacity (zero rows past n), so the compiled propensity programs
        # are reused by every epoch at the same capacity.
        from ..sys.environment import local_cpu_device
        cpu = local_cpu_device()
        if not hasattr(self, "_prop_jit"):
            self._prop_jit = jax.jit(self.model.propensity,
                                     static_argnums=1)
        constraints = self.state_set.constraints
        states_pad = np.zeros((n_pad, states.shape[1]), np.int64)
        states_pad[:n] = states
        with jax.default_device(cpu):
            states_j = jax.device_put(states_pad, cpu)
            for k, r in enumerate(self.enable_reactions):
                # Off-diagonal: who flows INTO row x (source x - s_r),
                # exactly the reference's column construction
                # (FspMatrixBase.cpp:132-145)
                src = states - stoich[r][None, :]
                idx = self.state_set.state2index(src)
                ok = idx >= 0
                src_idx[k, :n] = np.where(ok, idx, 0)
                a_src = np.asarray(self._prop_jit(
                    jax.device_put(states_pad - stoich[r][None, :], cpu),
                    r), dtype=np.float64)[:n]
                off_val[k, :n] = np.where(ok, a_src, 0.0)
                # Diagonal: full outflow rate a_r(x)
                diag_val[k, :n] = np.asarray(self._prop_jit(states_j, r),
                                             dtype=np.float64)[:n]
                # Sink bits: constraints violated by the target x + s_r
                viol = ~constraints.satisfied(states + stoich[r][None, :])
                bits = np.zeros(n, dtype=np.uint32)
                for c in range(n_c):
                    bits |= viol[:, c].astype(np.uint32) << c
                sink_bits[k, :n] = bits

        #: host copies, for operators that re-lay the arrays out
        #: (ShardedEllOperator's shard plan)
        self._host_arrays = {"src_idx": src_idx, "off_val": off_val,
                             "diag_val": diag_val, "sink_bits": sink_bits}
        self.src_idx = jnp.asarray(src_idx)
        self.off_val = jnp.asarray(off_val, self.dtype)
        self.diag_val = jnp.asarray(diag_val, self.dtype)
        self.sink_bits = jnp.asarray(sink_bits)
        self._nnz = int((off_val != 0).sum() + n)
        (offsets, bucket_delta, bucket_id, rem_row, rem_src, rem_val,
         rem_rid) = self._build_buckets(src_idx, off_val, n)
        self._data = EllOpData(src_idx=self.src_idx, off_val=self.off_val,
                               diag_val=self.diag_val,
                               sink_bits=self.sink_bits,
                               offsets=jnp.asarray(offsets),
                               bucket_delta=jnp.asarray(bucket_delta),
                               bucket_id=jnp.asarray(bucket_id),
                               rem_row=jnp.asarray(rem_row),
                               rem_src=jnp.asarray(rem_src),
                               rem_val=jnp.asarray(rem_val, self.dtype),
                               rem_rid=jnp.asarray(rem_rid))

    #: offsets per reaction served by dynamic rolls; the residue gathers
    K_BUCKETS = int(__import__("os").environ.get("PACMENSL_ELL_BUCKETS",
                                                 "8"))

    def _build_buckets(self, src_idx, off_val, n):
        """Top-K gather-offset buckets per reaction + compacted residue.

        Host-side numpy over the assembly arrays (one bincount per
        reaction); the residue capacity is laddered so expansion epochs
        keep stable shapes."""
        R, n_pad = src_idx.shape
        K = self.K_BUCKETS
        rows = np.arange(n_pad, dtype=np.int64)
        offsets = np.zeros((R, n_pad), np.int32)
        bucket_delta = np.zeros((R, K), np.int32)
        bucket_id = np.full((R, n_pad), K, np.int8)
        static = []
        rem_r, rem_s, rem_v, rem_id = [], [], [], []
        for r in range(R):
            active = off_val[r] != 0
            offs = np.where(active, src_idx[r] - rows, 0).astype(np.int64)
            offsets[r] = offs
            if active.any():
                vals, counts = np.unique(offs[active], return_counts=True)
                top = vals[np.argsort(counts)[::-1][:K]]
                # ascending order: the bucket SET is what the compiled
                # static-roll program bakes in; sorting keeps it stable
                # across epochs whose top-K membership is unchanged
                top = np.sort(top)
            else:
                top = np.zeros(0, np.int64)
            # pad unused buckets with the first delta (duplicate buckets
            # match the same rows twice — forbidden).  Use an impossible
            # delta instead: n_pad (no row can have src = i + n_pad).
            bd = np.full(K, n_pad, np.int64)
            bd[:top.shape[0]] = top
            bucket_delta[r] = bd.astype(np.int32)
            static.append(tuple(int(v) for v in top))
            for k in range(top.shape[0]):
                bucket_id[r][active & (offs == top[k])] = k
            in_bucket = np.isin(offs, top) & active
            res = active & ~in_bucket
            if res.any():
                idx = np.nonzero(res)[0]
                rem_r.append(idx.astype(np.int32))
                rem_s.append(src_idx[r][idx].astype(np.int32))
                rem_v.append(off_val[r][idx])
                rem_id.append(np.full(idx.size, r, np.int32))
        m = sum(x.shape[0] for x in rem_r)
        m_pad = max(_capacity_ladder(max(m, 1), 256),
                    getattr(self, "_rem_pad", 0))
        self._rem_pad = m_pad
        self._rem_frac = m / max(self._nnz, 1)
        rem_row = np.zeros(m_pad, np.int32)
        rem_src = np.zeros(m_pad, np.int32)
        rem_val = np.zeros(m_pad, np.float64)
        rem_rid = np.zeros(m_pad, np.int32)
        o = 0
        for rr, ss, vv, ii in zip(rem_r, rem_s, rem_v, rem_id):
            rem_row[o:o + rr.size] = rr
            rem_src[o:o + rr.size] = ss
            rem_val[o:o + rr.size] = vv
            rem_rid[o:o + rr.size] = ii
            o += rr.size
        #: static per-reaction bucket deltas, baked into the compiled
        #: action as STATIC roll shifts (a static rotate is two plain
        #: slices; a dynamic one is not).  reassemble() reports a change
        #: as program-invalidating.
        self.bucket_static = tuple(static)
        return (offsets, bucket_delta, bucket_id, rem_row, rem_src,
                rem_val, rem_rid)

    def data(self) -> EllOpData:
        """Epoch data to thread through jitted solves as an argument.  In
        plain-gather mode the bucket arrays are left out: the plain matvec
        never reads them, and their laddered shapes would otherwise force
        recompiles of the solve."""
        if self._gather_mode() == "bucket":
            return self._data
        return self._data._replace(**{f: None for f in _BUCKET_FIELDS})

    def _gather_mode(self) -> str:
        """'plain' (XLA's element gather) unless PACMENSL_ELL_GATHER=bucket.
        On the H100 the plain gather is 18-40x faster than the bucket-shift
        gather on the repressilator's t=10 set (PERF.md); ROADMAP D4
        removes the bucket path."""
        import os
        return ("bucket" if os.environ.get("PACMENSL_ELL_GATHER") == "bucket"
                else "plain")

    # ------------------------------------------------------------ action
    def action(self, t, y: FspVector,
               data: Optional[EllOpData] = None) -> FspVector:
        if data is None:
            data = self._data
        p = y.p                                    # [n_pad]
        c_full = self.model.coefficients(t, self.dtype)
        c = jnp.asarray(
            [c_full[r] for r in self.enable_reactions])  # [R]

        if self._gather_mode() == "bucket":
            # Bucket-shift gather: rows whose source offset equals a
            # bucket delta read p through a roll (p[i + d] =
            # roll(p, -d)[i], contiguous copies instead of an element
            # gather); the residue is a compacted gather + scatter-add.
            # STATIC roll shifts (self.bucket_static, baked at trace
            # time; see _build_buckets) deduplicated across reactions:
            # each distinct delta rolls p ONCE and serves every
            # (reaction, bucket) pair using it.  Wrapped reads only land
            # on rows whose bucket_id does not match (every active row's
            # true source is in range), so wrap needs no special
            # handling.
            R = len(self.enable_reactions)
            by_delta = {}
            for r, deltas in enumerate(self.bucket_static):
                for k, d in enumerate(deltas):
                    by_delta.setdefault(int(d), []).append((r, k))
            contribs = [jnp.zeros_like(p) for _ in range(R)]
            for d in sorted(by_delta):
                pr = jnp.roll(p, -d) if d else p
                for (r, k) in by_delta[d]:
                    w = jnp.where(data.bucket_id[r] == k,
                                  data.off_val[r], 0.0)
                    contribs[r] = contribs[r] + w * pr
            inflow = jnp.zeros_like(p)
            for r in range(R):
                inflow = inflow + c[r] * contribs[r]
            upd = data.rem_val * p[data.rem_src] * c[data.rem_rid]
            inflow = inflow.at[data.rem_row].add(upd)
            dp = inflow - p * (c @ data.diag_val)
        else:
            gathered = data.off_val * p[data.src_idx]    # [R, n_pad]
            dp = c @ gathered - p * (c @ data.diag_val)

        n_c = self.num_constraints
        # [R, n_c, n_pad] bit test fused into the reduction
        bit = jnp.arange(n_c, dtype=jnp.uint32)
        viol = ((data.sink_bits[:, None, :] >> bit[None, :, None]) & 1
                ).astype(self.dtype)
        weighted = (c[:, None, None] * data.diag_val[:, None, :]) * viol
        dsinks = jnp.tensordot(weighted, p, axes=([2], [0])).sum(axis=0)
        return FspVector(p=dp, sinks=dsinks)

    def __call__(self, t, y, data=None):
        return self.action(t, y, data)

    def diagonal(self, t=0.0, data: Optional[EllOpData] = None
                 ) -> jnp.ndarray:
        """diag(A(t)) = -sum_r c_r(t) a_r(x) over the padded vector."""
        if data is None:
            data = self._data
        c_full = self.model.coefficients(t, self.dtype)
        c = jnp.asarray([c_full[r] for r in self.enable_reactions])
        return -(c @ data.diag_val)

    # ------------------------------------------------------------- misc
    @property
    def num_constraints(self) -> int:
        return self.state_set.num_constraints

    def zero_vector(self) -> FspVector:
        return FspVector(p=jnp.zeros((self.n_pad,), self.dtype),
                         sinks=jnp.zeros((self.num_constraints,), self.dtype))

    def local_mv_flops(self) -> float:
        """Reference GetLocalMVFlops analogue (2 flops per nonzero)."""
        return 2.0 * self._nnz

    def nnz(self) -> int:
        return self._nnz

    def dense_matrix(self, t: float = 0.0) -> np.ndarray:
        """Materialize the full operator incl. sink rows (tests only)."""
        n, n_c = self.n_states, self.num_constraints
        A = np.zeros((n + n_c, n))
        c = np.asarray(jax.device_get(
            self.model.coefficients(t, self.dtype)))
        off = np.asarray(jax.device_get(self.off_val))
        dia = np.asarray(jax.device_get(self.diag_val))
        src = np.asarray(jax.device_get(self.src_idx))
        bits = np.asarray(jax.device_get(self.sink_bits))
        for k, r in enumerate(self.enable_reactions):
            for i in range(n):
                if off[k, i] != 0:
                    A[i, src[k, i]] += c[r] * off[k, i]
                A[i, i] -= c[r] * dia[k, i]
                for cc in range(n_c):
                    if (bits[k, i] >> cc) & 1:
                        A[n + cc, i] += c[r] * dia[k, i]
        return A
