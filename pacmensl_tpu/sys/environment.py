"""Runtime environment: init/finalize and device-mesh ownership.

Equivalent of the reference's ``PACMENSLInit/PACMENSLFinalize`` and RAII
``Environment`` (``src/Sys/Sys.h:62-80``, ``Sys.cpp:31-63,122-197``), which
idempotently initialize MPI + PETSc + Zoltan.  Here there is no
process-level runtime to boot — JAX owns the devices — so the Environment's
job is (a) idempotent ``jax.distributed`` initialization for multi-host runs,
(b) constructing and caching the 1-D device mesh over which the state axis is
sharded, and (c) scoped teardown.

The reference's ``sequential_action`` (rank-ordered serialized execution,
``Sys.cpp:83-113``) has no analogue here because the host program is a single
Python process even for multi-chip runs; it is provided as a trivial
pass-through for API parity.
"""
from __future__ import annotations

import atexit
from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False
_owns_distributed = False

#: Name of the mesh axis along which the FSP state space is sharded.
STATE_AXIS = "states"


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Idempotent runtime init (reference ``PACMENSLInit``, Sys.cpp:31-63).

    For single-host runs this is a no-op.  For multi-host (DCN) runs, pass
    the ``jax.distributed`` coordinator parameters.
    """
    global _initialized, _owns_distributed
    if _initialized:
        return
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _owns_distributed = True
    _initialized = True


def finalize() -> None:
    """Idempotent teardown (reference ``PACMENSLFinalize``)."""
    global _initialized, _owns_distributed
    if not _initialized:
        return
    if _owns_distributed:
        try:
            jax.distributed.shutdown()
        except Exception:
            pass
        _owns_distributed = False
    _initialized = False


class Environment:
    """Scoped runtime environment (reference RAII ``Environment``).

    Usable as a context manager::

        with Environment() as env:
            mesh = env.mesh()
    """

    def __init__(self, devices: Optional[Sequence] = None, **init_kwargs):
        init(**init_kwargs)
        self._devices = list(devices) if devices is not None else jax.devices()
        self._mesh: Optional[Mesh] = None
        atexit.register(finalize)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def num_devices(self) -> int:
        return len(self._devices)

    def mesh(self, n_devices: Optional[int] = None) -> Mesh:
        """1-D mesh over ``STATE_AXIS`` (the FSP domain-decomposition axis).

        This is the analogue of the reference's contiguous 1-D row
        partition of the state space across MPI ranks
        (``StateSetBase.h:133-144``).
        """
        devs = self._devices if n_devices is None else self._devices[:n_devices]
        if self._mesh is None or len(self._mesh.devices.ravel()) != len(devs):
            self._mesh = Mesh(np.array(devs), (STATE_AXIS,))
        return self._mesh

    def sequential_action(self, fn: Callable[[], None]) -> None:
        """Reference ``sequential_action`` parity: single host => just run."""
        fn()


def local_cpu_device():
    """The process-LOCAL host CPU device for assembly-time helper jits.

    Multi-process safety: ``jax.devices("cpu")[0]`` is the *global* device
     0, which on processes > 0 is non-addressable — committing assembly
    scratch work to it raises (and would ship bytes over DCN if it
    didn't).  Host-side sweeps must stay on this process's own CPU, like
    the reference's per-rank local Armadillo scratch."""
    return jax.local_devices(backend="cpu")[0]


_default_env: Optional[Environment] = None


def default_environment() -> Environment:
    global _default_env
    if _default_env is None:
        _default_env = Environment()
    return _default_env
