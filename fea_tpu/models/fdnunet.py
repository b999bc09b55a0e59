"""FDN-UNet model family (NHWC).

The trained architecture of the reference — split encoder / decoder /
auxiliary-range-decoder (model/fdnunetwithaux.py:341-894) — plus the
monolithic attention variant FDNUNet (model/fdnunet.py:381-657) used by
its sampling notebooks.

Channel plan for the default config (input_dim=64, 4 stages):
  stagewise dims [64, 64, 64, 128, 256, 512][:5] -> [64, 64, 128, 256, 512]
  encoder: init conv -> 4 x [2 FDN resblocks + down] -> 2 FDN middle blocks
  decoder: 4 x [2 plain resblocks (skip concat) + up] -> final resblock
           -> 1x1 conv -> amax normalization
  aux: middle flattened -> MLP -> (sigmoid sign head, log head)

Each model is a frozen dataclass of its hyperparameters with
`init(key, *inputs) -> {"params": tree}` and `apply(variables, *inputs)`
(models/layers.py).
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax.numpy as jnp

from .attention import full_attention, linear_attention
from .blocks import (
    amax_normalize,
    auxiliary_range_predictor,
    condition_feature_extractor,
    conditioned_resnet_block,
    downsample,
    upsample,
)
from .layers import Model, Scope, conv
from .time_embedding import time_embedding_mlp


def _stage_dims(input_dim: int, initial_dim: Optional[int], num_stages: int):
    initial = initial_dim if initial_dim is not None else input_dim
    return [initial] + [input_dim * (2**i) for i in range(num_stages)]


def _check_divisible(x, num_stages: int):
    max_resolution = 2 ** (num_stages - 1)
    if any(d % max_resolution for d in x.shape[1:3]):
        raise ValueError(
            f"spatial dims {x.shape[1:3]} must be divisible by {max_resolution}"
        )


@dataclass(frozen=True)
class FDNUNetEncoder(Model):
    """Down path + middle (fdnunetwithaux.py:341-667). Returns
    (middle, hidden_states x 2*num_stages, residual)."""

    input_dim: int
    initial_dim: Optional[int] = None
    num_stages: int = 4
    num_channels: int = 3
    num_auxiliary_condition_channels: int = 3
    num_condition_channels: Optional[int] = None
    num_groups: int = 8

    def forward(self, s: Scope, x, x_auxiliary_condition, x_self_condition=None):
        _check_divisible(x, self.num_stages)
        dims = _stage_dims(self.input_dim, self.initial_dim, self.num_stages)
        pairs = list(zip(dims[:-1], dims[1:]))

        if self.num_condition_channels is not None:
            if x_self_condition is None:
                x_self_condition = jnp.zeros_like(x)
            x = jnp.concatenate([x, x_self_condition], axis=-1)

        x = conv(s, x, dims[0], name="initial_conv")
        residual = x

        features = condition_feature_extractor(
            s, x_auxiliary_condition, dims, name="condition_feature_extractor"
        )

        def block(x, dim, feats, name):
            return conditioned_resnet_block(
                s, x, dim, feats, num_groups=self.num_groups, name=name
            )

        hidden_states = []
        for index, (in_dim, out_dim) in enumerate(pairs):
            x = block(x, in_dim, features[index], f"down{index}_block1")
            hidden_states.append(x)
            x = block(x, in_dim, features[index], f"down{index}_block2")
            hidden_states.append(x)
            if index == self.num_stages - 1:
                x = conv(s, x, out_dim, name=f"down{index}_conv")
            else:
                x = downsample(s, x, out_dim, name=f"down{index}_downsample")

        x = block(x, dims[-1], features[-1], "middle_block_1")
        x = block(x, dims[-1], features[-1], "middle_block_2")
        return x, hidden_states, residual


@dataclass(frozen=True)
class FDNUNetDecoder(Model):
    """Up path with skip concatenation and amax output normalization
    (fdnunetwithaux.py:670-802)."""

    input_dim: int
    initial_dim: Optional[int] = None
    final_dim: Optional[int] = None
    num_stages: int = 4
    num_channels: int = 3
    num_condition_channels: Optional[int] = None
    num_groups: int = 8

    def forward(self, s: Scope, x, hidden_states: List[jnp.ndarray], residual):
        dims = _stage_dims(self.input_dim, self.initial_dim, self.num_stages)
        pairs = list(zip(dims[:-1], dims[1:]))
        final_dim = (
            self.final_dim if self.final_dim is not None else self.num_channels
        )

        def block(x, dim, name):
            return conditioned_resnet_block(
                s, x, dim, use_fdn=False, num_groups=self.num_groups, name=name
            )

        hidden = list(hidden_states)
        for index, (in_dim, out_dim) in enumerate(reversed(pairs)):
            x = jnp.concatenate([x, hidden.pop()], axis=-1)
            x = block(x, out_dim, f"up{index}_block1")
            x = jnp.concatenate([x, hidden.pop()], axis=-1)
            x = block(x, out_dim, f"up{index}_block2")
            if index == self.num_stages - 1:
                x = conv(s, x, in_dim, name=f"up{index}_conv")
            else:
                x = upsample(s, x, in_dim, name=f"up{index}_upsample")

        x = jnp.concatenate([x, residual], axis=-1)
        x = block(x, dims[0], "final_resnet")
        x = conv(s, x, final_dim, (1, 1), padding=0, name="final_conv")
        # amax (signed max, not abs) normalization — a faithful quirk of
        # the reference (fdnunetwithaux.py:800), zero-divisor guarded.
        return amax_normalize(x)


@dataclass(frozen=True)
class FDNUNetAuxDecoder(Model):
    """Auxiliary range decoder over middle features
    (fdnunetwithaux.py:805-828)."""

    middle_dim: int
    final_dim: int
    image_height: int
    image_width: int
    hidden_dim: int = 256
    num_layers: int = 3
    num_stages: int = 4

    def forward(self, s: Scope, x):
        return auxiliary_range_predictor(
            s,
            x,
            output_dim=self.final_dim * 2,
            hidden_dim=self.hidden_dim,
            num_layers=self.num_layers,
            name="auxiliary_range_predictor",
        )


def create_models(
    input_dim: int,
    image_height: int,
    image_width: int,
    range_prediction_hidden_dim: int = 256,
    range_prediction_num_layers: int = 3,
    initial_dim: Optional[int] = None,
    final_dim: Optional[int] = None,
    num_stages: int = 4,
    num_channels: int = 3,
    num_auxiliary_condition_channels: int = 3,
    num_condition_channels: Optional[int] = None,
    resnet_num_groups_for_normalization: int = 8,
) -> Tuple[FDNUNetEncoder, FDNUNetDecoder, FDNUNetAuxDecoder]:
    """Wire the three modules with matched dims (fdnunetwithaux.py:831-894)."""
    dims = _stage_dims(input_dim, initial_dim, num_stages)
    encoder = FDNUNetEncoder(
        input_dim=input_dim,
        initial_dim=initial_dim,
        num_stages=num_stages,
        num_channels=num_channels,
        num_auxiliary_condition_channels=num_auxiliary_condition_channels,
        num_condition_channels=num_condition_channels,
        num_groups=resnet_num_groups_for_normalization,
    )
    decoder = FDNUNetDecoder(
        input_dim=input_dim,
        initial_dim=initial_dim,
        final_dim=final_dim,
        num_stages=num_stages,
        num_channels=num_channels,
        num_condition_channels=num_condition_channels,
        num_groups=resnet_num_groups_for_normalization,
    )
    auxiliary = FDNUNetAuxDecoder(
        middle_dim=dims[-1],
        final_dim=final_dim if final_dim is not None else num_channels,
        image_height=image_height,
        image_width=image_width,
        hidden_dim=range_prediction_hidden_dim,
        num_layers=range_prediction_num_layers,
        num_stages=num_stages,
    )
    return encoder, decoder, auxiliary


@dataclass(frozen=True)
class FDNUNet(Model):
    """Monolithic FDN-UNet with per-stage attention (model/fdnunet.py:381-657):
    LinearAttention at outer stages, FullAttention at the innermost stage
    and the middle block; optional self-conditioning channel and optional
    time embedding (the diffusion-mode hooks)."""

    input_dim: int
    initial_dim: Optional[int] = None
    final_dim: Optional[int] = None
    num_stages: int = 4
    num_channels: int = 3
    num_auxiliary_condition_channels: int = 3
    num_condition_channels: Optional[int] = None
    num_groups: int = 8
    attention_head_dim: int = 32
    num_attention_heads: int = 4
    use_full_attention: bool = False
    use_time_embedding: bool = False

    def forward(
        self, s: Scope, x, x_auxiliary_condition, x_self_condition=None, time=None
    ):
        _check_divisible(x, self.num_stages)
        dims = _stage_dims(self.input_dim, self.initial_dim, self.num_stages)
        pairs = list(zip(dims[:-1], dims[1:]))
        final_dim = (
            self.final_dim if self.final_dim is not None else self.num_channels
        )
        full_attn = (
            (True,) * self.num_stages
            if self.use_full_attention
            else (False,) * (self.num_stages - 1) + (True,)
        )

        if self.num_condition_channels is not None:
            if x_self_condition is None:
                x_self_condition = jnp.zeros_like(x)
            x = jnp.concatenate([x, x_self_condition], axis=-1)

        time_embedding = None
        if self.use_time_embedding and time is not None:
            time_embedding = time_embedding_mlp(s, time, self.input_dim)

        x = conv(s, x, dims[0], name="initial_conv")
        residual = x
        features = condition_feature_extractor(
            s, x_auxiliary_condition, dims, name="condition_feature_extractor"
        )

        def attn(x, use_full, name):
            fn = full_attention if use_full else linear_attention
            return fn(
                s,
                x,
                num_heads=self.num_attention_heads,
                head_dim=self.attention_head_dim,
                name=name,
            )

        def block(x, dim, feats, name):
            return conditioned_resnet_block(
                s,
                x,
                dim,
                feats,
                time_embedding,
                use_fdn=feats is not None,
                num_groups=self.num_groups,
                name=name,
            )

        hidden_states = []
        for index, (in_dim, out_dim) in enumerate(pairs):
            x = block(x, in_dim, features[index], f"down{index}_block1")
            hidden_states.append(x)
            x = block(x, in_dim, features[index], f"down{index}_block2")
            x = attn(x, full_attn[index], f"down{index}_attention") + x
            hidden_states.append(x)
            if index == self.num_stages - 1:
                x = conv(s, x, out_dim, name=f"down{index}_conv")
            else:
                x = downsample(s, x, out_dim, name=f"down{index}_downsample")

        x = block(x, dims[-1], features[-1], "middle_block_1")
        x = attn(x, True, "middle_attention") + x
        x = block(x, dims[-1], features[-1], "middle_block_2")

        for index, (in_dim, out_dim) in enumerate(reversed(pairs)):
            x = jnp.concatenate([x, hidden_states.pop()], axis=-1)
            x = block(x, out_dim, None, f"up{index}_block1")
            x = jnp.concatenate([x, hidden_states.pop()], axis=-1)
            x = block(x, out_dim, None, f"up{index}_block2")
            x = attn(x, full_attn[-(index + 1)], f"up{index}_attention") + x
            if index == self.num_stages - 1:
                x = conv(s, x, in_dim, name=f"up{index}_conv")
            else:
                x = upsample(s, x, in_dim, name=f"up{index}_upsample")

        x = jnp.concatenate([x, residual], axis=-1)
        x = block(x, dims[0], None, "final_resnet")
        x = conv(s, x, final_dim, (1, 1), padding=0, name="final_conv")
        return amax_normalize(x)
