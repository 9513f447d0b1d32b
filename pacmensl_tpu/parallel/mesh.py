"""Device-mesh sharding of the FSP state space.

Replacement for the reference's MPI domain decomposition
(``src/StateSet/StateSetBase.h:133-144``: contiguous 1-D row partition of
the state space across ranks, with PETSc VecScatter halo exchange inside
MatMult).  Here the probability array carries a ``NamedSharding`` over a
1-D mesh and GSPMD inserts the communication:

* box backend: the box is sharded along its largest axis; the stencil
  shifts of the matrix-free operator lower to neighbor collective-permutes
  (the halo exchange, carried by NCCL on GPUs), and reductions to psums.
* ELL backend: the flat state vector is sharded along its only axis.
  Under GSPMD the plain operator's gather lowers to an all-gather;
  :class:`~pacmensl_tpu.parallel.halo_ell.ShardedEllOperator` (what the
  solver builds on a mesh) exchanges only the halo, with one
  ``all_to_all``.

The reference's dynamic load re-balancing (Zoltan migration) corresponds
to re-applying ``device_put`` with a new sharding after expansion — data
movement is XLA's job, not hand-written pack/unpack callbacks.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sys.environment import STATE_AXIS


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the state axis."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (STATE_AXIS,))


def choose_shard_axis(shape: Tuple[int, ...], n_shards: int) -> Optional[int]:
    """Axis of the box to shard: the largest one with enough extent.

    Returns None when no axis is worth sharding (tiny problems stay
    replicated; matches the reference running on one rank).
    """
    if not shape:
        return None
    # device_put requires even sharding.  Axis 0 is preferred when it
    # divides evenly (the solver pads axis 0 to guarantee that, and its
    # halo planes are contiguous in the C-order layout).  Otherwise fall
    # back to the largest divisible axis.
    if shape[0] >= n_shards and shape[0] % n_shards == 0:
        return 0
    order = np.argsort(shape)[::-1]
    for axis in order:
        if shape[axis] >= n_shards and shape[axis] % n_shards == 0:
            return int(axis)
    return None


def box_spec(shape: Tuple[int, ...], n_shards: int) -> P:
    axis = choose_shard_axis(shape, n_shards)
    if axis is None:
        return P()
    spec = [None] * len(shape)
    spec[axis] = STATE_AXIS
    return P(*spec)


def shard_fsp_vector(y, mesh: Mesh):
    """Place an FspVector on the mesh: p sharded, sinks replicated."""
    from ..ops.vecops import FspVector
    n = mesh.devices.size
    if y.p.ndim == 1:
        spec = P(STATE_AXIS) if y.p.shape[0] >= n else P()
    else:
        spec = box_spec(y.p.shape, n)
    p = jax.device_put(y.p, NamedSharding(mesh, spec))
    sinks = jax.device_put(y.sinks, NamedSharding(mesh, P()))
    return FspVector(p=p, sinks=sinks)
