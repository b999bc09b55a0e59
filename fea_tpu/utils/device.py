"""Device-placement policy and the persistent compile cache."""

import os
from pathlib import Path
from typing import Optional

import jax

_CHECKOUT = Path(__file__).resolve().parents[2]


def compilation_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`.
    The path is fixed: it is part of the cache's key, so a directory
    that moved between runs would never hit."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        _CHECKOUT / ".jax_cache"
    )


def enable_compilation_cache() -> str:
    """Point JAX's persistent compile cache at `compilation_cache_dir()`
    and return it. Bucketed shapes mean a handful of kernels in all, so
    a warm cache makes restarts and repeated runs cheap. Failures raise."""
    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


def raster_device() -> Optional[jax.Device]:
    """Device for raster/locate kernels; None = JAX's default device (the
    accelerator). `FEA_TPU_RASTER_DEVICE=cpu` runs them on the host CPU
    backend instead, for A/B measurements."""
    if os.environ.get("FEA_TPU_RASTER_DEVICE", "accel") != "cpu":
        return None
    # local_devices, not devices: under a multi-process runtime
    # jax.devices() is the GLOBAL list and [0] can be another process's
    # (non-addressable) device — placing the raster kernel there makes
    # the result unfetchable.
    return jax.local_devices(backend="cpu")[0]
