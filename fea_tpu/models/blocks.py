"""FDN-UNet building blocks (NHWC).

Topology mirrors the reference's trained architecture
(model/fdnunetwithaux.py:24-338): SPADE-style feature denormalization
conditioning, lean resnet blocks, space-to-depth downsampling and
nearest-upsample + conv upsampling. Data layout is NHWC rather than
the reference's NCHW; channel counts and connectivity are identical.

Each block is a function of a parent `Scope` (models/layers.py) that
opens its own child scope, so the parameter tree nests as the blocks do.
"""

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .layers import Scope, conv, dense, group_norm


def amax_normalize(x: jnp.ndarray, eps: float = 1e-4) -> jnp.ndarray:
    """x / max(x) over spatial dims — the reference's signed-amax output
    normalization (fdnunetwithaux.py:800), with a zero-divisor guard.

    Unguarded, a batch whose final-conv activations are all nonpositive
    with zeros present yields 0/0 = NaN (observed once in a bf16
    production run: loss 0.32 -> nan in a single step with fully-finite
    inputs). The divisor is clamped away from zero sign-preservingly;
    the guard only changes results where the reference itself would
    produce inf/NaN garbage.
    """
    m = jnp.max(x, axis=(1, 2), keepdims=True)
    m = jnp.where(m >= 0, jnp.maximum(m, eps), jnp.minimum(m, -eps))
    return x / m


def downsample(s: Scope, x, output_dim: int, name: Optional[str] = None):
    """Space-to-depth (2x2) then 1x1 conv (fdnunetwithaux.py:24-38)."""
    s = s.child("Downsample", name)
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return conv(s, x, output_dim, (1, 1), padding=0)


def upsample(s: Scope, x, output_dim: int, name: Optional[str] = None):
    """Nearest 2x upsample then 3x3 conv (fdnunetwithaux.py:41-53)."""
    s = s.child("Upsample", name)
    x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return conv(s, x, output_dim)


def feature_denormalization(
    s: Scope, x, features, num_groups: int = 8, name: Optional[str] = None
):
    """SPADE-style conditioning (fdnunetwithaux.py:56-81): parameter-free
    GroupNorm, then per-pixel scale/shift predicted from condition
    features by 3x3 convs, then SiLU."""
    if features.shape[1:3] != x.shape[1:3]:
        raise ValueError("features must share spatial dims with x")
    s = s.child("FeatureDenormalization", name)
    dim = x.shape[-1]
    x = group_norm(s, x, num_groups, affine=False)
    scale = conv(s, features, dim, name="scale_conv")
    shift = conv(s, features, dim, name="shift_conv")
    return jax.nn.silu(x * (scale + 1.0) + shift)


def condition_feature_extractor(
    s: Scope, x, stagewise_dimensions: Sequence[int], name: Optional[str] = None
) -> List[jnp.ndarray]:
    """Condition pyramid (fdnunetwithaux.py:84-137): shared conv stem
    32->64->128->128, then one head per UNet stage producing features at
    that stage's resolution and width."""
    s = s.child("ConditionFeatureExtractor", name)
    for width in (32, 64, 128, 128):
        x = jax.nn.silu(conv(s, x, width))

    dims = list(stagewise_dimensions)
    pairs = list(zip(dims[:-1], dims[1:]))

    features = []
    x = jax.nn.silu(conv(s, x, pairs[0][0]))
    features.append(x)
    for index, (_in, out) in enumerate(pairs):
        if index == len(pairs) - 1:
            x = conv(s, x, out)
        else:
            x = downsample(s, x, out)
        x = jax.nn.silu(x)
        features.append(x)
    return features


def _scale_shift(x, scale_shift: Optional[Tuple]):
    if scale_shift is None:
        return x
    scale, shift = scale_shift
    return x * (scale + 1.0) + shift


def lean_resnet_sub_block(
    s: Scope, x, output_dim: int, scale_shift=None, name: Optional[str] = None
):
    """Conv + SiLU (no norm) — used when FDN provides normalization
    (fdnunetwithaux.py:140-154)."""
    s = s.child("LeanResnetSubBlock", name)
    x = conv(s, x, output_dim)
    return jax.nn.silu(_scale_shift(x, scale_shift))


def resnet_sub_block(
    s: Scope,
    x,
    output_dim: int,
    num_groups: int = 8,
    scale_shift=None,
    name: Optional[str] = None,
):
    """Conv + GroupNorm + SiLU (fdnunetwithaux.py:157-175)."""
    s = s.child("ResnetSubBlock", name)
    x = conv(s, x, output_dim)
    x = group_norm(s, x, num_groups)
    return jax.nn.silu(_scale_shift(x, scale_shift))


def conditioned_resnet_block(
    s: Scope,
    x,
    output_dim: int,
    condition_features=None,
    time_embedding=None,
    use_fdn: bool = True,
    num_groups: int = 8,
    name: Optional[str] = None,
):
    """Two sub-blocks + residual 1x1 (fdnunetwithaux.py:178-277).

    use_fdn=True: FDN conditioning before each sub-block (encoder path);
    use_fdn=False: plain GroupNorm sub-blocks (decoder path).
    Optional time embedding adds a per-channel scale/shift after the first
    projection (the reference's vestigial DDPM path, kept functional)."""
    s = s.child("ConditionedResnetBlock", name)
    h = x
    if use_fdn:
        if condition_features is None:
            raise ValueError("an FDN block needs condition features")
        h = feature_denormalization(s, h, condition_features, num_groups, "fdn1")

    scale_shift = None
    if time_embedding is not None:
        emb = dense(s, jax.nn.silu(time_embedding), output_dim * 2)
        emb = emb[:, None, None, :]
        scale_shift = jnp.split(emb, 2, axis=-1)

    if use_fdn:
        h = lean_resnet_sub_block(s, h, output_dim, scale_shift, name="block1")
        h = feature_denormalization(s, h, condition_features, num_groups, "fdn2")
        h = lean_resnet_sub_block(s, h, output_dim, name="block2")
    else:
        h = resnet_sub_block(
            s, h, output_dim, num_groups, scale_shift, name="block1"
        )
        h = resnet_sub_block(s, h, output_dim, num_groups, name="block2")

    if x.shape[-1] != output_dim:
        x = conv(s, x, output_dim, (1, 1), padding=0, name="residual_conv")
    return h + x


def auxiliary_range_predictor(
    s: Scope,
    x,
    output_dim: int,
    hidden_dim: int = 256,
    num_layers: int = 3,
    name: Optional[str] = None,
):
    """Flatten the middle features and predict displacement ranges via an
    MLP with a sigmoid sign head and a linear log-magnitude head
    (fdnunetwithaux.py:280-338)."""
    s = s.child("AuxiliaryRangePredictor", name)
    x = x.reshape(x.shape[0], -1)
    x = jax.nn.relu(dense(s, x, hidden_dim))
    for _ in range(num_layers - 2):
        x = jax.nn.relu(dense(s, x, hidden_dim))
    sign = jax.nn.relu(dense(s, x, hidden_dim))
    sign = jax.nn.sigmoid(dense(s, sign, output_dim))
    log = jax.nn.relu(dense(s, x, hidden_dim))
    log = dense(s, log, output_dim)
    return sign, log
