"""Sinusoidal time embedding (reference fdnunet.py:83-99 — commented out
of the reference's forward paths, but part of the documented capability
surface for the conditional-diffusion mode)."""

import math
from typing import Optional

import jax
import jax.numpy as jnp

from .layers import Scope, dense


def sinusoidal_pos_emb(positions, embedding_dim: int, theta: int = 10000):
    half = embedding_dim // 2
    freq = math.log(theta) / (half - 1)
    freq = jnp.exp(jnp.arange(half) * -freq)
    angles = positions[:, None] * freq[None, :]
    return jnp.concatenate([jnp.sin(angles), jnp.cos(angles)], axis=-1)


def time_embedding_mlp(s: Scope, t, input_dim: int, name: Optional[str] = None):
    """SinusoidalPosEmb -> Linear -> GELU -> Linear (fdnunet.py:406-412)."""
    s = s.child("TimeEmbeddingMLP", name)
    dim = input_dim * 4
    x = sinusoidal_pos_emb(t, input_dim)
    x = jax.nn.gelu(dense(s, x, dim))
    return dense(s, x, dim)
