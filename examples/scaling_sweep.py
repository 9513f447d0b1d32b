"""Multi-chip scaling sweep.

Mirror of the reference ``submit_scalability_multi_nodes.sh`` (1-32 MPI
ranks x {Block, Graph} partitioning on the repressilator): runs the
repressilator SpMV hot loop over increasing mesh sizes for

* the dense-box operator (GSPMD stencil: XLA inserts the halo
  collective-permutes), and
* the compressed ELL operator with the explicit halo-exchange plan
  (parallel/halo_ell.py) under BLOCK and GRAPH orderings,

and reports throughput, parallel efficiency, and the exchange sizes.

On real hardware this needs a multi-GPU host; for a functional check it
runs on virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/scaling_sweep.py -max_devices 8
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _bench(act, y, iters):
    import jax
    out = act(0.0, y)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = act(0.0, out)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    import jax
    import jax.numpy as jnp
    import pacmensl_tpu as pm
    from pacmensl_tpu.parallel.mesh import make_mesh, shard_fsp_vector
    from pacmensl_tpu.parallel.halo_ell import ShardedEllOperator
    from pacmensl_tpu.ops.box_operator import BoxOperator
    from pacmensl_tpu.ops.ell_operator import EllOperator
    from pacmensl_tpu.ops.vecops import FspVector
    from pacmensl_tpu.statespace.box_space import BoxStateSpace
    from pacmensl_tpu.statespace.constraints import ConstraintSet
    from pacmensl_tpu.statespace.state_set import StateSet
    from pacmensl_tpu.statespace.partitioner import (StatePartitioner,
                                                     PartitioningType)

    opts = pm.Options.from_argv(argv)
    max_dev = opts.get_int("max_devices", len(jax.devices()))
    iters = opts.get_int("iters", 50)
    bound = opts.get_int("bound", 63)

    b = pm.models.repressilator()

    # ---- dense-box path (hyper-rectangle stage of the reference bench)
    print("== box operator (GSPMD stencil) ==")
    cs = ConstraintSet(None, np.array([bound] * 3), np.full(3, 0.2))
    base = None
    n = 1
    while n <= max_dev:
        space = BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                              pad_quanta=[max_dev, 1, 1])
        mesh = make_mesh(n) if n > 1 else None
        op = BoxOperator(b.model, space)
        rng = np.random.default_rng(0)
        p = rng.random(space.shape) * np.asarray(jax.device_get(op.mask_f))
        y = FspVector(p=jnp.asarray(p, op.dtype),
                      sinks=jnp.zeros(space.num_constraints, op.dtype))
        if mesh is not None:
            y = shard_fsp_vector(y, mesh)
        dt = _bench(jax.jit(op.action), y, iters)
        thr = op.nnz() / dt
        if base is None:
            base = thr
        print(f"devices={n:2d} {dt*1e6:9.1f} us/matvec "
              f"{thr/1e9:8.3f} Gnnz/s  eff={thr/(base*n):6.1%}")
        n *= 2

    # ---- compressed ELL path, BLOCK vs GRAPH (reference sweep axes)
    print("== ELL operator (explicit halo exchange) ==")
    csq = ConstraintSet(b.constraint, b.bounds * 4, b.expansion_factors)
    ss0 = StateSet(b.model.stoichiometry, csq, init_states=b.x0)
    ss0.expand()
    for ptype in ("block", "graph"):
        ss = StateSet(b.model.stoichiometry, csq, init_states=b.x0)
        ss.expand()
        if ptype == "graph":
            part = StatePartitioner(PartitioningType.GRAPH)
            res = part.partition(ss.states, b.model.stoichiometry, max_dev,
                                 state2index=ss.state2index)
            ss.reorder(res.order)
        base = None
        n = 1
        while n <= max_dev:
            if n == 1:
                op = EllOperator(b.model, ss)
            else:
                op = ShardedEllOperator(b.model, ss, make_mesh(n))
            rng = np.random.default_rng(0)
            pv = np.zeros(op.n_pad)
            pv[:ss.num_states] = rng.random(ss.num_states)
            y = op.zero_vector()
            y = FspVector(p=y.p + jnp.asarray(pv, op.dtype), sinks=y.sinks)
            dt = _bench(jax.jit(op.action), y, iters)
            thr = op.nnz() / dt
            if base is None:
                base = thr
            halo = getattr(op, "halo_width", 0)
            print(f"devices={n:2d} [{ptype:5s}] {dt*1e6:9.1f} us/matvec "
                  f"{thr/1e9:8.3f} Gnnz/s  eff={thr/(base*n):6.1%}  "
                  f"halo={halo}")
            n *= 2


if __name__ == "__main__":
    main()
