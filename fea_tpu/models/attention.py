"""Attention blocks for the FDN-UNet attention variant and plain UNet.

Mirrors the reference semantics (model/fdnunet.py:62-80, 263-378):
channelwise RMSNorm, linear attention (softmax-kernel, O(N)) at outer
stages, full attention at the innermost stage, both with a small bank of
learned memory key/values. Full attention is the plain einsum-softmax
chain, which XLA fuses; the inner stage's sequence is at most
(S/8)^2 + 4 tokens with head_dim 32. (The reference switched between
torch's flash SDPA and this chain, attentionutils.py:13-95.)
"""

from typing import Optional

import jax
import jax.numpy as jnp

from .layers import Scope, conv, ones


def rms_norm(s: Scope, x, name: Optional[str] = None):
    """Channelwise RMS norm with learned gain (fdnunet.py:62-80), NHWC."""
    s = s.child("RMSNorm", name)
    dim = x.shape[-1]
    g = s.param("g", ones, (1, 1, 1, dim))
    norm = x * jnp.sqrt(dim) / jnp.linalg.norm(x, axis=-1, keepdims=True).clip(
        1e-12
    )
    return norm * g


def _memory_kv(s: Scope, shape):
    return s.param("memory_kv", jax.nn.initializers.normal(1.0), shape)


def linear_attention(
    s: Scope,
    x,
    num_heads: int = 4,
    head_dim: int = 32,
    num_memory_kv: int = 4,
    name: Optional[str] = None,
):
    """softmax(q over d) . softmax(k over n) linear attention with learned
    memory KV slots (fdnunet.py:263-329)."""
    s = s.child("LinearAttention", name)
    b, h, w, c = x.shape
    hd = num_heads * head_dim

    x_in = rms_norm(s, x)
    qkv = conv(s, x_in, hd * 3, (1, 1), padding=0, use_bias=False)
    q, k, v = jnp.split(qkv, 3, axis=-1)

    def heads(t):  # (b, h, w, hd) -> (b, heads, d, n)
        return t.reshape(b, h * w, num_heads, head_dim).transpose(0, 2, 3, 1)

    q, k, v = heads(q), heads(k), heads(v)

    mem = _memory_kv(s, (2, num_heads, head_dim, num_memory_kv))
    mk = jnp.broadcast_to(mem[0], (b,) + mem[0].shape)
    mv = jnp.broadcast_to(mem[1], (b,) + mem[1].shape)
    k = jnp.concatenate([mk, k], axis=-1)
    v = jnp.concatenate([mv, v], axis=-1)

    q = jax.nn.softmax(q, axis=-2) * (head_dim**-0.5)
    k = jax.nn.softmax(k, axis=-1)

    context = jnp.einsum("bhdn,bhen->bhde", k, v)
    out = jnp.einsum("bhde,bhdn->bhen", context, q)  # (b, heads, d, n)
    out = out.transpose(0, 3, 1, 2).reshape(b, h, w, hd)
    out = conv(s, out, c, (1, 1), padding=0)
    return rms_norm(s, out)


def softmax_attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over (b, heads, n, d) operands."""
    scores = jnp.einsum("bhnd,bhmd->bhnm", q, k) * (q.shape[-1] ** -0.5)
    return jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(scores, axis=-1), v)


def full_attention(
    s: Scope,
    x,
    num_heads: int = 4,
    head_dim: int = 32,
    num_memory_kv: int = 4,
    name: Optional[str] = None,
):
    """Full softmax attention over flattened pixels with memory KV
    (fdnunet.py:332-378)."""
    s = s.child("FullAttention", name)
    b, h, w, c = x.shape
    hd = num_heads * head_dim

    x_in = rms_norm(s, x)
    qkv = conv(s, x_in, hd * 3, (1, 1), padding=0, use_bias=False)
    q, k, v = jnp.split(qkv, 3, axis=-1)

    def heads(t):  # -> (b, heads, n, d)
        return t.reshape(b, h * w, num_heads, head_dim).transpose(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)

    mem = _memory_kv(s, (2, num_heads, num_memory_kv, head_dim))
    mk = jnp.broadcast_to(mem[0], (b,) + mem[0].shape)
    mv = jnp.broadcast_to(mem[1], (b,) + mem[1].shape)
    k = jnp.concatenate([mk, k], axis=-2)
    v = jnp.concatenate([mv, v], axis=-2)

    out = softmax_attention(q, k, v)
    out = out.transpose(0, 2, 1, 3).reshape(b, h, w, hd)
    return conv(s, out, c, (1, 1), padding=0)
