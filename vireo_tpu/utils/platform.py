"""Persistent compile-cache placement shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
this module sets nothing. Otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (git-ignored): the path is part of the cache
key, so it must not move from one run to the next.

The backend is JAX's own choice; ``JAX_PLATFORMS=cpu`` forces the host.
"""

import os

__all__ = ["DEFAULT_CACHE_DIR", "apply_compile_cache", "require_gpu",
           "card_name_and_power_limit"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def apply_compile_cache():
    """Point JAX's persistent compile cache at `DEFAULT_CACHE_DIR`
    unless ``JAX_COMPILATION_CACHE_DIR`` is set. Call before the first
    compile. Returns the directory set, or None when the environment
    decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """The local JAX devices, or SystemExit when they are not GPUs: a
    device measurement never falls back to the CPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit("no GPU: JAX found %s devices"
                         % devs[0].platform)
    return devs


def card_name_and_power_limit():
    """`nvidia-smi --query-gpu=name,power.limit` as printed, one line
    per card (the card's name and power limit belong beside every
    device number)."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
