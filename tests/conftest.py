"""Test configuration: run every test on a virtual 8-device CPU mesh.

Multi-chip behavior is validated the way the reference validates MPI
behavior — by actually running on multiple (virtual) devices — rather than
by mocking (SURVEY.md §4 takeaway 4).

JAX may already be imported when this file runs, so forcing the CPU needs
``jax.config`` as well as the environment variables.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pacmensl_tpu  # noqa: E402,F401  (sets x64 before array creation)

# No persistent compilation cache, even when JAX_COMPILATION_CACHE_DIR is
# set: XLA:CPU executables with collectives (the 8-device virtual mesh)
# deadlock at their rendezvous when loaded back from the cache and abort
# the process after the hardcoded 40 s timeout (reproduced
# deterministically; see pacmensl_tpu.config.compile_cache_dir).
jax.config.update("jax_compilation_cache_dir", None)

assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8, jax.devices()


import importlib.util  # noqa: E402
import os as _os  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py, imported as a module (it sits at the repo root)."""
    path = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
