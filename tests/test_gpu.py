"""Checks that need an NVIDIA GPU (marker `gpu`).

Each test decides inside itself whether a card is present and skips
otherwise; `python chip_smoke.py` runs them on the card (phase 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _require_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def test_attention_implementations_agree_on_gpu():
    """The einsum chain the models use against
    jax.nn.dot_product_attention's XLA and cuDNN implementations, in
    bf16 at the inner stage's shape (q 1024, kv 1028, head_dim 32)."""
    _require_gpu()
    from fea_tpu.models.attention import softmax_attention

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(k1, (2, 4, 1024, 32), jnp.bfloat16)
    k = jax.random.normal(k2, (2, 4, 1028, 32), jnp.bfloat16)
    v = jax.random.normal(k3, (2, 4, 1028, 32), jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(
            softmax_attention(*(a.astype(jnp.float32) for a in (q, k, v)))
        )
    t = lambda x: x.transpose(0, 2, 1, 3)
    got = {"einsum": softmax_attention(q, k, v)}
    for impl in ("xla", "cudnn"):
        got[impl] = t(
            jax.nn.dot_product_attention(t(q), t(k), t(v), implementation=impl)
        )
    for name, out in got.items():
        err = np.abs(np.asarray(out, np.float32) - want).max()
        # bf16 operands and output: 8-bit mantissa on values of size ~1
        assert err < 3e-2, f"{name}: max-abs error {err}"


def test_element_stiffness_is_full_precision_on_gpu():
    """The device stiffness matches the float64 host stiffness to float32
    accuracy (2e-6 on the CPU): its contractions are pinned to precision
    HIGHEST, so no TF32 (~1e-3 relative) enters the FEM."""
    _require_gpu()
    from fea_tpu.fem.elasticity import (
        element_stiffness,
        element_stiffness_np,
        plane_strain_stiffness,
    )

    from fea_tpu.mesh import triangulate

    plate = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.5], [0.0, 0.5]])
    mesh = triangulate(plate, mesh_size=0.05)
    coords, tris = mesh.coords, mesh.triangles
    young = np.full(len(tris), 210000.0)
    poisson = np.full(len(tris), 0.3)
    Ke_ref = element_stiffness_np(coords, tris, young, poisson)[0]
    D = plane_strain_stiffness(210000.0, 0.3)
    Ke = element_stiffness(
        jnp.asarray(coords, jnp.float32), jnp.asarray(tris, jnp.int32),
        jnp.asarray(D, jnp.float32),
    )[0]
    Ke = np.moveaxis(np.asarray(Ke, np.float64), -1, 0)  # (M, 6, 6)
    scale = np.abs(Ke_ref).max(axis=(1, 2), keepdims=True)
    rel = (np.abs(Ke - Ke_ref) / scale).max()
    assert rel < 1e-5, f"relative stiffness error {rel}"
