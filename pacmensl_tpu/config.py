"""Global configuration for pacmensl_tpu.

The reference library (pacmensl) is double-precision throughout (PETSc
``PetscReal`` = f64), so 64-bit mode is enabled at import and float64 is
the default dtype.  Every solver object also takes a ``dtype``, so a
float32 solve stays one argument away.

This module must be imported before any JAX arrays are created, because
``jax_enable_x64`` has to be set at import time.  It never initializes a
backend: ``jax.distributed.initialize`` must run before any
backend-initializing call (the reference's PACMENSLInit-before-everything
contract, Sys.cpp:31-63).
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

# Exact-f32 matmuls.  On the GPU, XLA may run float32 contractions in
# TF32 (about three decimal digits) unless "highest" is asked for — fine
# for neural nets, poison for probability transport: noise-level mass at
# far states feeds boundary sink flux and drives runaway FSP expansion.
# The hot stencil/gather paths use no large matmuls, so this costs only
# the small Hessenberg expm / basis-lincomb contractions.
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_enable_x64", True)

#: Persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: one fixed path inside the checkout, because the path is part
#: of the cache key and a moving directory never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def gpu_plugin_installed() -> bool:
    """Whether JAX's CUDA plug-in is installed (looked up, not imported:
    no backend is initialized)."""
    from importlib.metadata import entry_points
    from importlib.util import find_spec
    if any("cuda" in ep.name or "cuda" in ep.value
           for ep in entry_points(group="jax_plugins")):
        return True
    return any(find_spec(m) is not None
               for m in ("jax_cuda12_plugin", "jax_cuda13_plugin"))


def compile_cache_dir(environ: Mapping[str, str] = os.environ,
                      platforms: Optional[str] = None,
                      gpu_plugin: Optional[bool] = None) -> Optional[str]:
    """Directory this package points JAX's persistent compile cache at,
    or None when it sets nothing.

    FSP solves re-jit on every capacity rung and across solver
    instances; identical programs (operator data are jit arguments, not
    baked constants) then load from the cache instead of recompiling.

    * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is
      set here.
    * A GPU run: :data:`DEFAULT_CACHE_DIR`.  The run is on the GPU when
      ``JAX_PLATFORMS`` names ``cuda`` (or ``gpu``), or, when it names
      nothing, when the CUDA plug-in is installed (JAX then picks it).
    * Anything else, CPU-only runs in particular: no cache.  XLA:CPU
      executables with collectives (multi-device virtual meshes)
      deadlock when loaded back from the persistent cache: every
      participant stalls at a collective rendezvous and the hardcoded
      40 s termination timeout aborts the process.  Reproduced
      deterministically — fresh compile passes, cache hit aborts.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if platforms is None:
        platforms = (jax.config.jax_platforms
                     or environ.get("JAX_PLATFORMS", ""))
    names = {p.strip().lower() for p in platforms.split(",") if p.strip()}
    if names:
        on_gpu = bool(names & {"cuda", "gpu"})
    else:
        on_gpu = gpu_plugin_installed() if gpu_plugin is None else gpu_plugin
    return DEFAULT_CACHE_DIR if on_gpu else None


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)

import jax.numpy as jnp  # noqa: E402  (after x64 flag)

#: Default floating point dtype for probability vectors and operators.
DEFAULT_DTYPE = jnp.float64

#: Default integer dtype for state coordinates.
STATE_DTYPE = jnp.int32

#: Default integer dtype for linearized state keys (mixed-radix indices).
KEY_DTYPE = jnp.int64


def default_dtype():
    return DEFAULT_DTYPE
