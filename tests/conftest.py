"""Test configuration: JAX on a virtual 8-device CPU mesh, float64 on.

`JAX_PLATFORMS` defaults to cpu here; multi-device sharding is checked
on the virtual devices (xla_force_host_platform_device_count). Tests
marked `gpu` need an NVIDIA card: each decides inside the test whether
one is present and skips otherwise; `python chip_smoke.py` runs them on
the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Float64 for FEM parity tests (device runs use f32 + refinement instead).
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one"
    )
