"""Parameter scopes and the primitive layers the models are built from.

A model's forward is written once against a `Scope`. During `init` the
scope creates each parameter it is asked for (and so fixes the tree's
shape); during `apply` it reads the same parameter back from the tree.
Unnamed children are named `<Kind>_<n>`, counted per kind within their
parent, so a parameter tree reads `encoder/down0_block1/fdn1/Conv_0/kernel`.

Layers compute in the dtype of their inputs and parameters (the trainer
casts both for bf16 compute); normalization statistics are always taken
in at least float32.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones


class Scope:
    """One node of a parameter tree: creates (init) or reads (apply)."""

    def __init__(self, params: Dict, key: Optional[jax.Array] = None):
        self.params = params
        self.key = key
        self._counts: Dict[str, int] = {}
        self._draws = 0

    @property
    def initializing(self) -> bool:
        return self.key is not None

    def _next_key(self) -> jax.Array:
        self._draws += 1
        return jax.random.fold_in(self.key, self._draws)

    def child(self, kind: str, name: Optional[str] = None) -> "Scope":
        if name is None:
            index = self._counts.get(kind, 0)
            self._counts[kind] = index + 1
            name = f"{kind}_{index}"
        if self.initializing:
            return Scope(self.params.setdefault(name, {}), self._next_key())
        return Scope(self.params[name])

    def param(
        self,
        name: str,
        init: Callable,
        shape: Sequence[int],
        dtype=jnp.float32,
    ) -> jax.Array:
        if self.initializing:
            self.params[name] = init(self._next_key(), tuple(shape), dtype)
        return self.params[name]


class Model:
    """Base for models: `init(key, *inputs) -> {"params": tree}` and
    `apply({"params": tree}, *inputs)`. Subclasses define
    `forward(scope, *inputs)`."""

    def forward(self, scope: Scope, *args, **kwargs):
        raise NotImplementedError

    def init(self, key: jax.Array, *args, **kwargs) -> Dict:
        scope = Scope({}, key)
        self.forward(scope, *args, **kwargs)
        return {"params": scope.params}

    def apply(self, variables: Dict, *args, **kwargs):
        return self.forward(Scope(variables["params"]), *args, **kwargs)


def _cast(dtype, *arrays):
    return tuple(None if a is None else a.astype(dtype) for a in arrays)


def conv(
    s: Scope,
    x: jax.Array,
    features: int,
    kernel_size: Tuple[int, int] = (3, 3),
    padding=1,
    use_bias: bool = True,
    name: Optional[str] = None,
) -> jax.Array:
    """2-D convolution over NHWC with an HWIO kernel."""
    s = s.child("Conv", name)
    kernel = s.param(
        "kernel", lecun_normal, tuple(kernel_size) + (x.shape[-1], features)
    )
    bias = s.param("bias", zeros, (features,)) if use_bias else None
    dtype = jnp.result_type(x, kernel, *([bias] if use_bias else []))
    x, kernel, bias = _cast(dtype, x, kernel, bias)
    pad = padding if isinstance(padding, str) else [(padding, padding)] * 2
    y = lax.conv_general_dilated(
        x,
        kernel,
        window_strides=(1, 1),
        padding=pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y if bias is None else y + bias


def dense(
    s: Scope, x: jax.Array, features: int, name: Optional[str] = None
) -> jax.Array:
    s = s.child("Dense", name)
    kernel = s.param("kernel", lecun_normal, (x.shape[-1], features))
    bias = s.param("bias", zeros, (features,))
    x, kernel, bias = _cast(jnp.result_type(x, kernel, bias), x, kernel, bias)
    y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    return y + bias


def group_norm(
    s: Scope,
    x: jax.Array,
    num_groups: int,
    affine: bool = True,
    eps: float = 1e-6,
    name: Optional[str] = None,
) -> jax.Array:
    """GroupNorm over NHWC. Statistics in at least float32 (mean and
    E[x^2] - mean^2, clipped at 0); output in the dtype of x and the
    scale/bias."""
    channels = x.shape[-1]
    scale = bias = None
    if affine:
        s = s.child("GroupNorm", name)
        scale = s.param("scale", ones, (channels,))
        bias = s.param("bias", zeros, (channels,))
    group_size = channels // num_groups
    stat_dtype = jnp.promote_types(x.dtype, jnp.float32)
    xg = x.reshape(x.shape[:-1] + (num_groups, group_size)).astype(stat_dtype)
    axes = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
    mean = xg.mean(axes)
    var = jnp.maximum(0.0, (xg * xg).mean(axes) - mean * mean)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (channels,)
    mean = jnp.repeat(mean, group_size, axis=-1).reshape(shape)
    var = jnp.repeat(var, group_size, axis=-1).reshape(shape)
    y = x - mean
    mul = lax.rsqrt(var + eps)
    if affine:
        mul = mul * scale
    y = y * mul
    if affine:
        y = y + bias
    out_dtype = (
        jnp.result_type(x, scale, bias) if affine else jnp.result_type(x)
    )
    return y.astype(out_dtype)
