"""Device microbench of the compressed (ELL) backend matvec.

Times the bucket-shift gather against the plain XLA element gather on the
repressilator's custom-constraint state set at the bounds its t=10
benchmark solve reaches (~1.1M states), in insertion order (what the
solver uses under the default BLOCK partitioning) and after the GRAPH
locality ordering.  Reports us/matvec and Gnnz/s for each via the
two-point K-slope, in the library's default dtype.

Usage: python tools/ell_bench.py [BOUND_SCALE]
Env: PACMENSL_ELL_GATHER is overridden per mode internally.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

import pacmensl_tpu as pm
from pacmensl_tpu.ops.ell_operator import EllOperator
from pacmensl_tpu.ops.vecops import FspVector
from pacmensl_tpu.statespace.constraints import ConstraintSet
from pacmensl_tpu.statespace.state_set import StateSet


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_action(op, data, p, iters=None):
    iters = iters or int(os.environ.get("ITERS", "96"))
    n_c = op.num_constraints

    def chain(k, p0):
        def body(_, acc):
            out = op.action(
                0.5, FspVector(p=acc, sinks=jnp.zeros(n_c, op.dtype)), data)
            return out.p
        return lax.fori_loop(0, k, body, p0)

    f = jax.jit(chain, static_argnums=0)
    lo, hi = iters, 4 * iters
    t0 = time.perf_counter()
    f(lo, p).block_until_ready()
    log(f"  compile+run lo: {time.perf_counter()-t0:.1f}s")
    f(hi, p).block_until_ready()
    t0 = time.perf_counter(); f(lo, p).block_until_ready()
    t1 = time.perf_counter(); f(hi, p).block_until_ready()
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (hi - lo)


def main():
    # bounds of the repressilator t=10 benchmark solve
    bounds = np.array([147, 147, 177, 5241, 5720, 6290])
    if len(sys.argv) > 1:
        bounds = np.ceil(bounds * float(sys.argv[1])).astype(np.int64)
    b = pm.models.repressilator()
    cs = ConstraintSet(b.constraint, bounds, b.expansion_factors)
    t0 = time.perf_counter()
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    log(f"state set: {ss.num_states} states [{time.perf_counter()-t0:.1f}s]")
    for order in ("insertion", "graph"):
        if order == "graph":
            from pacmensl_tpu.statespace.partitioner import (
                StatePartitioner, PartitioningType, PartitioningApproach)
            t0 = time.perf_counter()
            part = StatePartitioner(PartitioningType.GRAPH,
                                    PartitioningApproach.FROMSCRATCH)
            res = part.partition(ss.states, b.model.stoichiometry, 1,
                                 state2index=ss.state2index,
                                 need_boundaries=False)
            ss.reorder(res.order)
            log(f"locality order (RCM): [{time.perf_counter()-t0:.1f}s]")
        for mode in ("bucket", "plain"):
            os.environ["PACMENSL_ELL_GATHER"] = mode
            t0 = time.perf_counter()
            op = EllOperator(b.model, ss)
            log(f"{order}/{mode}: assemble {time.perf_counter()-t0:.1f}s "
                f"n_pad={op.n_pad} nnz={op.nnz()} "
                f"residue={op._rem_frac:.3f} dtype={op.dtype.__name__}")
            rng = np.random.default_rng(0)
            p = jnp.asarray(rng.random(op.n_pad), op.dtype)
            dt = time_action(op, op.data(), p)
            log(f"{order}/{mode}: {dt*1e6:.1f} us/matvec -> "
                f"{op.nnz()/dt/1e9:.2f} Gnnz/s")


if __name__ == "__main__":
    main()
