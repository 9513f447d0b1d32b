"""Multi-process (jax.distributed) smoke test: the reference library's
whole purpose is multi-node MPI (Sys.cpp:31-63); here the analogue is a
2-process jax.distributed CPU run whose collectives cross the process
boundary.  The test actually spawns 2 worker processes (no mocking,
SURVEY.md §4 takeaway 4) that each own 4 virtual devices of an 8-device
global mesh and run a halo-exchange sharded matvec against a host oracle.
"""
import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.medium
def test_two_process_distributed_matvec():
    coordinator = f"127.0.0.1:{_free_port()}"
    # no inherited XLA flags, platform pins or import hooks: the workers
    # must start with an UNinitialized backend so
    # jax.distributed.initialize can run first.  No compile cache either:
    # XLA:CPU collectives deadlock when loaded back from it
    # (pacmensl_tpu.config.compile_cache_dir).
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH",
                        "JAX_COMPILATION_CACHE_DIR")}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coordinator, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=360)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n"
                    + "\n".join(o or "" for o in outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "DISTOK" in out, f"worker {pid} missing sentinel:\n{out}"
        assert "DISTSOLVEOK" in out, \
            f"worker {pid} full-solve sentinel missing:\n{out}"
