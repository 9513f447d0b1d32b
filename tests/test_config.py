"""Compile-cache policy (pacmensl_tpu.config.compile_cache_dir)."""
import os
import subprocess
import sys

import jax

from pacmensl_tpu.config import DEFAULT_CACHE_DIR, compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_variable_set_means_nothing_is_set_here():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
    assert compile_cache_dir(env, platforms="") is None
    assert compile_cache_dir(env, platforms="cuda") is None


def test_accelerator_run_uses_fixed_path_in_checkout():
    assert compile_cache_dir({}, platforms="", gpu_plugin=True) == \
        DEFAULT_CACHE_DIR
    assert compile_cache_dir({}, platforms="cuda,cpu") == DEFAULT_CACHE_DIR
    assert compile_cache_dir({}, platforms="cuda,cpu",
                             gpu_plugin=False) == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_cpu_only_runs_stay_off_the_cache():
    assert compile_cache_dir({}, platforms="cpu") is None
    assert compile_cache_dir({}, platforms=" CPU ") is None
    assert compile_cache_dir({}, platforms="cpu", gpu_plugin=True) is None
    # a CPU-only host that leaves JAX_PLATFORMS unset
    assert compile_cache_dir({}, platforms="", gpu_plugin=False) is None
    # the test session itself (8 virtual CPU devices) never caches
    assert jax.config.jax_compilation_cache_dir is None


def _cache_dir_after_import(extra_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "XLA_FLAGS")}
    env.update(extra_env)
    code = ("import pacmensl_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_import_respects_variable_and_default(tmp_path):
    """In a fresh process: the variable wins untouched; without it a GPU
    run gets the fixed default path, and an unpinned platform follows
    whether the CUDA plug-in is installed."""
    from pacmensl_tpu.config import gpu_plugin_installed
    var = str(tmp_path / "cache")
    assert _cache_dir_after_import(
        {"JAX_COMPILATION_CACHE_DIR": var}) == var
    assert _cache_dir_after_import(
        {"JAX_PLATFORMS": "cuda,cpu"}) == DEFAULT_CACHE_DIR
    assert _cache_dir_after_import({}) == (
        DEFAULT_CACHE_DIR if gpu_plugin_installed() else "None")
    assert _cache_dir_after_import({"JAX_PLATFORMS": "cpu"}) == "None"
