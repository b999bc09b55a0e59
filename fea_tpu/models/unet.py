"""Plain conditional UNet baseline (reference model/unet.py:287-546 —
lucidrains-style; unused by the reference's current training but part of
its model-family surface). Conditions are concatenated input channels
(no FDN); attention is linear at outer stages and full at the innermost;
output uses the same amax normalization."""

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp

from .attention import full_attention, linear_attention
from .blocks import amax_normalize, conditioned_resnet_block, downsample, upsample
from .fdnunet import _check_divisible, _stage_dims
from .layers import Model, Scope, conv
from .time_embedding import time_embedding_mlp


@dataclass(frozen=True)
class UNet(Model):
    input_dim: int
    initial_dim: Optional[int] = None
    final_dim: Optional[int] = None
    num_stages: int = 4
    num_channels: int = 3
    num_condition_channels: Optional[int] = None
    self_condition: bool = False
    num_groups: int = 8
    attention_head_dim: int = 32
    num_attention_heads: int = 4
    use_full_attention: bool = False
    use_time_embedding: bool = False

    def forward(self, s: Scope, x, x_condition=None, x_self_condition=None, time=None):
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

        if self.self_condition:
            if x_self_condition is None:
                x_self_condition = jnp.zeros_like(x)
            x = jnp.concatenate([x, x_self_condition], axis=-1)
        if self.num_condition_channels is not None and x_condition is not None:
            x = jnp.concatenate([x, x_condition], axis=-1)

        time_embedding = None
        if self.use_time_embedding and time is not None:
            time_embedding = time_embedding_mlp(s, time, self.input_dim)

        def block(x, dim, name):
            return conditioned_resnet_block(
                s,
                x,
                dim,
                time_embedding=time_embedding,
                use_fdn=False,
                num_groups=self.num_groups,
                name=name,
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

        x = conv(s, x, dims[0], name="initial_conv")
        residual = x

        hidden_states = []
        for index, (in_dim, out_dim) in enumerate(pairs):
            x = block(x, in_dim, f"down{index}_block1")
            hidden_states.append(x)
            x = block(x, in_dim, f"down{index}_block2")
            x = attn(x, full_attn[index], f"down{index}_attention") + x
            hidden_states.append(x)
            if index == self.num_stages - 1:
                x = conv(s, x, out_dim, name=f"down{index}_conv")
            else:
                x = downsample(s, x, out_dim, name=f"down{index}_downsample")

        x = block(x, dims[-1], "middle_block_1")
        x = attn(x, True, "middle_attention") + x
        x = block(x, dims[-1], "middle_block_2")

        for index, (in_dim, out_dim) in enumerate(reversed(pairs)):
            x = jnp.concatenate([x, hidden_states.pop()], axis=-1)
            x = block(x, out_dim, f"up{index}_block1")
            x = jnp.concatenate([x, hidden_states.pop()], axis=-1)
            x = block(x, out_dim, f"up{index}_block2")
            x = attn(x, full_attn[-(index + 1)], f"up{index}_attention") + x
            if index == self.num_stages - 1:
                x = conv(s, x, in_dim, name=f"up{index}_conv")
            else:
                x = upsample(s, x, in_dim, name=f"up{index}_upsample")

        x = jnp.concatenate([x, residual], axis=-1)
        x = block(x, dims[0], "final_resnet")
        x = conv(s, x, final_dim, (1, 1), padding=0, name="final_conv")
        return amax_normalize(x)
