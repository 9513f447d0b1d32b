"""Halo-exchange sharded ELL operator (shard_map + all_to_all).

The reference's distributed SpMV (PETSc ``MatMult`` on MPISELL matrices,
``src/Matrix/FspMatrixBase.cpp:36-62``) hides a *halo exchange*: before the
local sparse matvec, a ``VecScatter`` ships exactly the off-process vector
entries each rank's off-diagonal block touches.  The plain
:class:`~pacmensl_tpu.ops.ell_operator.EllOperator` under GSPMD instead
lowers its gather to an **all-gather** of the whole probability vector —
correct, but O(n) bytes per device per matvec.  This module restores the
reference's communication volume on a device mesh:

* the state axis is block-partitioned over a 1-D device mesh (the
  reference's contiguous row partition, ``StateSetBase.h:133-144``);
* at assembly time the per-reaction source indices are classified
  local/remote, and per device-pair *request lists* are extracted — the
  moral equivalent of PETSc's VecScatter plan;
* the hot loop runs under ``shard_map``: each device gathers the values its
  neighbors asked for, one ``lax.all_to_all`` swaps them, and the
  local ELL matvec reads from ``concat(local p, received halo)`` with a
  single unified gather.  Sink contributions are computed on local rows and
  ``psum``-reduced (the reference's sink VecScatter-add,
  ``FspMatrixConstrained.cpp:31-64``).

Communication per matvec: O(D * S) values (S = max per-pair halo size)
instead of O(n_pad) — for the CME's stencil structure under a contiguous
(or RCM-ordered, see the GRAPH partitioner) layout, S is a thin boundary
band, so bytes between devices scale with the *surface* of each shard, not its
volume, exactly like the reference's MPI halos.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:                                     # jax >= 0.6
    from jax import shard_map as _shard_map
except ImportError:                      # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _shard_map

from typing import NamedTuple

from ..sys.environment import STATE_AXIS
from ..models.model import Model
from ..statespace.state_set import StateSet
from ..ops.ell_operator import EllOperator, _capacity_ladder
from ..ops.vecops import FspVector


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ShardedEllData(NamedTuple):
    """Per-epoch sharded operator arrays + exchange plan (jit argument,
    so within-capacity expansion epochs reuse the compiled solve).

    ``offs``/``bdelta``/``rem_*`` extend the bucket-shift gather (see
    :class:`~pacmensl_tpu.ops.ell_operator.EllOperator`) to the sharded
    hot loop: local-source rows whose offset hits a per-shard top-K
    bucket are served by dynamic rolls of the LOCAL block, and only the
    residue (remote sources + off-bucket locals) reads the
    halo-extended vector — so the ``all_to_all`` feeds nothing but the
    small residue gather and overlaps with the roll compute.  They are
    None in plain-gather mode."""
    send_idx: jnp.ndarray   # [D, D, S] int32 per-pair send gather plan
    src_uni: jnp.ndarray    # [D, R, L] int32 unified gather indices
    off: jnp.ndarray        # [D, R, L] off-diagonal values
    diag: jnp.ndarray       # [D, R, L] outflow values
    bits: jnp.ndarray       # [D, R, L] uint32 sink bitmasks
    offs: Optional[jnp.ndarray] = None     # [D, R, L] int32 local offset
    #                                        or L+1 sentinel
    bdelta: Optional[jnp.ndarray] = None   # [D, R, K] top-K offsets
    rem_row: Optional[jnp.ndarray] = None  # [D, M] residue destination rows
    rem_src: Optional[jnp.ndarray] = None  # [D, M] residue indices into ext
    rem_val: Optional[jnp.ndarray] = None  # [D, M] residue values (0 pad)
    rem_rid: Optional[jnp.ndarray] = None  # [D, M] residue reaction ids


#: ShardedEllData fields only the bucket-shift gather reads
_SH_BUCKET_FIELDS = ("offs", "bdelta", "rem_row", "rem_src", "rem_val",
                     "rem_rid")


class ShardedEllOperator(EllOperator):
    """ELL CME operator with explicit halo exchange over a 1-D mesh."""

    def __init__(self,
                 model: Model,
                 state_set: StateSet,
                 mesh: Mesh,
                 dtype=None,
                 capacity_floor: int = 0,
                 halo_floor: int = 0,
                 enable_reactions: Optional[Sequence[int]] = None):
        self.mesh = mesh
        self._D = int(mesh.devices.size)
        #: monotone halo padding: within-capacity epochs whose halo stays
        #: under the floor keep the [D, D, S] plan shape (no recompile)
        self._halo_floor = int(halo_floor)
        self._smapped_key = None
        # per-shard length divisible by the 128-lane register width
        super().__init__(model, state_set, dtype=dtype,
                         pad_to=128 * self._D,
                         capacity_floor=capacity_floor,
                         enable_reactions=enable_reactions)
        self._build_shards()

    def reassemble(self) -> bool:
        # the shard plan's key holds every shape and static choice the
        # compiled matvec bakes in (see _build_shards)
        key = self._smapped_key
        super().reassemble()
        self._build_shards()
        return self._smapped_key != key

    # --------------------------------------------------------- shard plan
    def _build_shards(self):
        """Derive the VecScatter-equivalent exchange plan (host, assembly
        time — never in the hot loop, SURVEY.md §7 hard part (c))."""
        D = self._D
        L = self.n_pad // D
        self.shard_len = L
        host = self._host_arrays                  # the assembly's arrays
        src, off = host["src_idx"], host["off_val"]          # [R, n_pad]
        R = src.shape[0]

        owner = src // L
        used = off != 0.0
        # request lists: reqs[d][o] = sorted unique global indices shard d
        # needs from shard o (o != d)
        reqs = [[np.zeros(0, np.int64)] * D for _ in range(D)]
        s_max = 1
        for d in range(D):
            sl = slice(d * L, (d + 1) * L)
            src_d, own_d, use_d = src[:, sl], owner[:, sl], used[:, sl]
            for o in range(D):
                if o == d:
                    continue
                g = np.unique(src_d[use_d & (own_d == o)])
                reqs[d][o] = g
                s_max = max(s_max, g.size)
        self.halo_width = _round_up(s_max, 8)     # true need (for reports)
        # laddered and monotone: most epochs keep the plan's shape
        self._halo_floor = max(self._halo_floor, _capacity_ladder(s_max, 8))
        S = self._halo_floor

        # send plan: on device o, send[e] = p_local[send_idx[o, e]]
        send_idx = np.zeros((D, D, S), np.int32)
        for d in range(D):
            for o in range(D):
                g = reqs[d][o]
                send_idx[o, d, :g.size] = (g - o * L).astype(np.int32)

        # unified gather index into concat(p_local [L], halo [D*S])
        src_uni = np.zeros((D, R, L), np.int32)
        for d in range(D):
            sl = slice(d * L, (d + 1) * L)
            src_d, own_d, use_d = src[:, sl], owner[:, sl], used[:, sl]
            uni = np.zeros((R, L), np.int64)
            local = use_d & (own_d == d)
            uni[local] = src_d[local] - d * L
            for o in range(D):
                if o == d or reqs[d][o].size == 0:
                    continue
                m = use_d & (own_d == o)
                pos = np.searchsorted(reqs[d][o], src_d[m])
                uni[m] = L + o * S + pos
            src_uni[d] = uni

        # local slices of the ELL data, leading axis = shard
        def shardify(a):                                    # [R, n_pad] ->
            return np.ascontiguousarray(                    # [D, R, L]
                np.asarray(a).reshape(a.shape[0], D, L).transpose(1, 0, 2))

        off_sh = shardify(off)

        mode = self._gather_mode()
        # the bucket plan is built only for the bucket-shift gather
        bucket, M = (self._bucket_plan(src_uni, off_sh) if mode == "bucket"
                     else (None, None))

        # host arrays go straight to their shards (no staging through one
        # device, which would compile a resharding slice per shape)
        row = NamedSharding(self.mesh, P(STATE_AXIS))
        fdt = np.dtype(self.dtype)

        def put(a, dtype=None):
            return jax.device_put(np.asarray(a, dtype), row)

        self._sh_data = ShardedEllData(
            send_idx=put(send_idx),
            src_uni=put(src_uni),
            off=put(off_sh, fdt),
            diag=put(shardify(host["diag_val"]), fdt),
            bits=put(shardify(host["sink_bits"])),
            **({} if bucket is None else {
                f: put(bucket[f], fdt if f == "rem_val" else None)
                for f in _SH_BUCKET_FIELDS}))

        n_c = self.num_constraints
        dtype = self.dtype
        # the residue length M shapes only the bucket path's arguments
        key = (self.shard_len, S, R, n_c, M, mode)
        if key == self._smapped_key:
            return                      # shapes unchanged: keep compiled fn
        self._smapped_key = key

        K_b = self.K_BUCKETS

        def local_mv(c, p_loc, send_ix, src_u, off_l, diag_l, bits_l,
                     *bucket_args):
            send_ix = send_ix[0]            # [D, S]
            src_u, off_l = src_u[0], off_l[0]
            diag_l, bits_l = diag_l[0], bits_l[0]
            # halo exchange: one all_to_all carries every pairwise list
            send = p_loc[send_ix]                         # [D, S]
            recv = lax.all_to_all(send, STATE_AXIS, 0, 0, tiled=True)
            ext = jnp.concatenate([p_loc, recv.reshape(-1)])
            if mode == "bucket":
                (offs_l, bdelta_l, rrow_l, rsrc_l, rval_l,
                 rrid_l) = (a[0] for a in bucket_args)
                # local-bucket rolls; the all_to_all result feeds only
                # the residue gather below, so it overlaps with them
                inflow = jnp.zeros_like(p_loc)
                for r in range(R):
                    contrib = jnp.zeros_like(p_loc)
                    for k in range(K_b):
                        dlt = bdelta_l[r, k]
                        pr = jnp.roll(p_loc, -dlt)
                        w = jnp.where(offs_l[r] == dlt, off_l[r], 0.0)
                        contrib = contrib + w * pr
                    inflow = inflow + c[r] * contrib
                upd = rval_l * ext[rsrc_l] * c[rrid_l]
                inflow = inflow.at[rrow_l].add(upd)
                dp = inflow - p_loc * (c @ diag_l)
            else:
                gathered = off_l * ext[src_u]             # [R, L]
                dp = c @ gathered - p_loc * (c @ diag_l)
            # sink rows on local states, reduced over the mesh
            bit = jnp.arange(n_c, dtype=jnp.uint32)
            viol = ((bits_l[:, None, :] >> bit[None, :, None]) & 1
                    ).astype(dtype)
            weighted = (c[:, None, None] * diag_l[:, None, :]) * viol
            ds = jnp.tensordot(weighted, p_loc, axes=([2], [0])).sum(axis=0)
            ds = lax.psum(ds, STATE_AXIS)
            return dp, ds

        n_args = 5 + (len(_SH_BUCKET_FIELDS) if mode == "bucket" else 0)
        self._smapped = _shard_map(
            local_mv, mesh=self.mesh,
            in_specs=(P(), P(STATE_AXIS)) + (P(STATE_AXIS),) * n_args,
            out_specs=(P(STATE_AXIS), P()))
        self._smapped_bucket = mode == "bucket"

    def _bucket_plan(self, src_uni, off_sh):
        """Per-shard bucket-shift plan (local rolls + residue) for the
        bucket gather: the ``_SH_BUCKET_FIELDS`` host arrays and the
        laddered residue length M."""
        D, R, L = off_sh.shape
        K = self.K_BUCKETS
        SENT = np.int32(L + 1)              # no local offset can equal it
        rows_l = np.arange(L, dtype=np.int64)
        offs_sh = np.full((D, R, L), SENT, np.int32)
        # bucket padding must differ from the remote-row sentinel, else a
        # padded bucket slot would match every remote row's offs entry
        bdelta = np.full((D, R, K), L + 2, np.int32)
        rem_lists = [[] for _ in range(D)]  # (row, src_uni, val, rid)
        used_total = max(int((off_sh != 0).sum()), 1)
        rem_total = 0
        for d in range(D):
            for r in range(R):
                use = off_sh[d, r] != 0.0
                local = use & (src_uni[d, r] < L)
                offs = src_uni[d, r].astype(np.int64) - rows_l
                offs_sh[d, r] = np.where(local, offs, SENT).astype(np.int32)
                if local.any():
                    vals, counts = np.unique(offs[local],
                                             return_counts=True)
                    top = vals[np.argsort(counts)[::-1][:K]]
                    bdelta[d, r, :top.shape[0]] = top.astype(np.int32)
                    in_b = np.isin(offs, top) & local
                else:
                    in_b = np.zeros(L, bool)
                res = use & ~in_b
                if res.any():
                    idx = np.nonzero(res)[0]
                    rem_lists[d].append(
                        (idx.astype(np.int32),
                         src_uni[d, r][idx].astype(np.int32),
                         off_sh[d, r][idx],
                         np.full(idx.size, r, np.int32)))
                    rem_total += idx.size
        m_max = max((sum(x[0].size for x in parts)
                     for parts in rem_lists), default=0)
        M = max(_capacity_ladder(max(m_max, 1), 8),
                getattr(self, "_rem_floor", 0))
        self._rem_floor = M
        self._rem_frac = rem_total / used_total
        rem_row = np.zeros((D, M), np.int32)
        rem_src = np.zeros((D, M), np.int32)
        rem_val = np.zeros((D, M), np.float64)
        rem_rid = np.zeros((D, M), np.int32)
        for d in range(D):
            o = 0
            for rr, ss, vv, ii in rem_lists[d]:
                rem_row[d, o:o + rr.size] = rr
                rem_src[d, o:o + rr.size] = ss
                rem_val[d, o:o + rr.size] = vv
                rem_rid[d, o:o + rr.size] = ii
                o += rr.size
        return {"offs": offs_sh, "bdelta": bdelta, "rem_row": rem_row,
                "rem_src": rem_src, "rem_val": rem_val,
                "rem_rid": rem_rid}, M

    # ------------------------------------------------------------ action
    def data(self) -> ShardedEllData:
        """The epoch's shard plan (the bucket fields are None in
        plain-gather mode)."""
        return self._sh_data

    def action(self, t, y: FspVector,
               data: Optional[ShardedEllData] = None) -> FspVector:
        if data is None:
            data = self._sh_data
        c_full = self.model.coefficients(t, self.dtype)
        c = jnp.asarray([c_full[r] for r in self.enable_reactions])
        args = (data.send_idx, data.src_uni, data.off, data.diag, data.bits)
        if self._smapped_bucket:
            args += tuple(getattr(data, f) for f in _SH_BUCKET_FIELDS)
        dp, dsinks = self._smapped(c, y.p, *args)
        return FspVector(p=dp, sinks=dsinks.astype(y.sinks.dtype))

    def diagonal(self, t=0.0, data: Optional[ShardedEllData] = None
                 ) -> jnp.ndarray:
        """diag(A(t)) over the padded vector; the sharded epoch data keeps
        the outflow values as [D, R, L] blocks (global row = d*L + l)."""
        if data is None:
            data = self._sh_data
        c_full = self.model.coefficients(t, self.dtype)
        c = jnp.asarray([c_full[r] for r in self.enable_reactions])
        return -jnp.einsum("r,drl->dl", c, data.diag).reshape(-1)

    def zero_vector(self) -> FspVector:
        row = NamedSharding(self.mesh, P(STATE_AXIS))
        rep = NamedSharding(self.mesh, P())
        return FspVector(
            p=jax.device_put(jnp.zeros((self.n_pad,), self.dtype), row),
            sinks=jax.device_put(jnp.zeros((self.num_constraints,),
                                           self.dtype), rep))

    def comm_values_per_matvec(self) -> int:
        """Values crossing between devices per matvec (for the scaling
        report);
        counts the padded exchange actually wired."""
        return self._D * self._D * self._halo_floor
