"""Benchmark: FSP SpMV throughput on the repressilator benchmark model.

Measures the hot kernel of every FSP solve — the truncated CME operator
action (the SpMV analogue of the reference's FspMatrixConstrained::Action,
``src/Matrix/FspMatrixBase.cpp:36-62``) — on the repressilator model
(reference ``examples/repressilator.cpp``) at a fixed benchmark-sized
state space: the hyper-rectangle {0..127}^3, 2,097,152 states.  The
space is built at *fixed bounds* so the benchmark is deterministic and
cheap to set up.

Baseline: the same operator as a scipy CSR matrix on the host CPU
(``pacmensl_tpu/ops/reference.py``) — structurally the reference's
stored-SELL single-rank hot loop.  ``vs_baseline`` = our nnz/s divided by
the CSR-on-CPU nnz/s.

Timing protocol: matvecs are chained inside one jitted ``lax.fori_loop``
(exactly how the Krylov integrator consumes them) and timed by the
two-point K-slope, which cancels the fixed dispatch cost.  Roofline: the
least bytes a matvec must move (read p, read the stored float mask, write
dp) over a chained plain XLA copy (``jnp.roll``) of a buffer far larger
than the GPU's 50 MB L2, timed the same way.

Runs on the GPU only; prints exactly ONE JSON line on stdout naming the
device; diagnostics go to stderr.
Env knobs:
  PACMENSL_BENCH_DTYPE=f64|f32   (default f64, the library's default)
  PACMENSL_BENCH_ITERS=K         (default 160; chained loop sizes K, 4K)
  PACMENSL_BENCH_BOUND=B         (default 127; coordinate bound per species)
"""
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def slope(run, k_lo, k_hi):
    """Seconds per iteration of ``run(K)`` (returns a device scalar) from
    the two-point K-slope, after one warm call of each size."""
    for k in (k_lo, k_hi):
        run(k).block_until_ready()
    t0 = time.perf_counter()
    run(k_lo).block_until_ready()
    t1 = time.perf_counter()
    run(k_hi).block_until_ready()
    t2 = time.perf_counter()
    return max((t2 - t1) - (t1 - t0), 1e-9) / (k_hi - k_lo)


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax
    if jax.default_backend() != "gpu":
        log(f"bench: backend {jax.default_backend()!r} is not the GPU")
        return 2
    from pacmensl_tpu.ops.box_operator import BoxOperator
    from pacmensl_tpu.ops.reference import box_space_fixed, generator_csr
    from pacmensl_tpu.ops.vecops import FspVector

    dtype = (jnp.float32 if os.environ.get("PACMENSL_BENCH_DTYPE") == "f32"
             else jnp.float64)
    k_lo = int(os.environ.get("PACMENSL_BENCH_ITERS", "160"))
    k_hi = 4 * k_lo
    bound = int(os.environ.get("PACMENSL_BENCH_BOUND", "127"))
    dev = jax.devices()[0]
    log(f"devices: {jax.devices()}  dtype: {dtype.__name__}")

    b, space = box_space_fixed(bound)
    op = BoxOperator(b.model, space, dtype=dtype)
    rng = np.random.default_rng(0)
    p = rng.random(space.shape) * space.mask_host
    p /= p.sum()
    y = FspVector(p=jnp.asarray(p, dtype),
                  sinks=jnp.zeros((space.num_constraints,), dtype))
    data = op.data()

    @jax.jit
    def chained(y, data, k):
        out = lax.fori_loop(0, k, lambda i, v: op.action(0.0, v, data), y)
        return out.p.sum() + out.sinks.sum()

    dt = slope(lambda k: chained(y, data, k), k_lo, k_hi)
    ref = generator_csr(b.model, np.argwhere(space.mask_host), None,
                        space.constraints.bounds)
    nnz = ref.nnz
    ours = nnz / dt
    log(f"box SpMV {space.shape}: n={space.num_states} nnz={nnz} "
        f"{dt * 1e6:.1f} us/matvec -> {ours / 1e9:.3f} Gnnz/s")

    itemsize = jnp.dtype(dtype).itemsize
    n_box = int(np.prod(space.shape))
    floor_bytes = 3 * n_box * itemsize
    x = jnp.zeros((max(n_box, 1 << 26),), dtype)

    @jax.jit
    def copies(x, k):
        return lax.fori_loop(0, k, lambda i, a: jnp.roll(a, 1), x)[0]

    copy_dt = slope(lambda k: copies(x, k), 8, 32)
    copy_bw = 2.0 * x.size * itemsize / copy_dt
    frac = floor_bytes / copy_bw / dt
    log(f"copy {x.size * itemsize / 2**20:.0f} MiB: {copy_bw / 1e9:.1f} GB/s;"
        f" matvec floor {floor_bytes / 1e6:.1f} MB -> "
        f"{floor_bytes / copy_bw * 1e6:.1f} us; fraction {frac:.3f}")

    v = rng.random(space.num_states)
    ref.A @ v
    t0 = time.perf_counter()
    for _ in range(10):
        ref.A @ v
    base_dt = (time.perf_counter() - t0) / 10
    base = nnz / base_dt
    log(f"CPU/CSR SpMV baseline: {base_dt * 1e6:.1f} us/matvec -> "
        f"{base / 1e9:.3f} Gnnz/s")

    print(json.dumps({
        "metric": "repressilator_spmv_nnz_per_s",
        "value": ours,
        "unit": "nnz/s",
        "vs_baseline": ours / base,
        "us_per_matvec": dt * 1e6,
        "roofline_fraction_of_copy": frac,
        "copy_gbps": copy_bw / 1e9,
        "dtype": dtype.__name__,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


def _watchdog(seconds: int):
    """Exit non-zero if the benchmark wedges: a benchmark that never
    returns is worse than one that reports failure."""
    import signal

    def on_alarm(signum, frame):
        log(f"WATCHDOG: bench exceeded {seconds}s; exiting")
        os._exit(3)

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)


if __name__ == "__main__":
    _watchdog(int(os.environ.get("PACMENSL_BENCH_TIMEOUT", "540")))
    sys.exit(main())
