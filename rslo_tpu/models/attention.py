"""Channel (SE) and spatial attention blocks.

Flax counterparts of the reference's attention layers
(/root/reference/rslo/layers/se_module.py:5-85), available to the BEV
blocks via config (off by default, matching the deployed configs).
"""
from __future__ import annotations

import jax.numpy as jnp
from .. import nn


class SELayer(nn.Module):
    """Squeeze-and-excitation over channels (NHWC)."""
    reduction: int = 16

    @nn.compact
    def __call__(self, x):
        C = x.shape[-1]
        s = jnp.mean(x, axis=(-3, -2))              # (B, C)
        s = nn.relu(nn.Dense(max(C // self.reduction, 1))(s))
        s = nn.sigmoid(nn.Dense(C)(s))
        return x * s[:, None, None, :]


class SpatialAttention(nn.Module):
    """Per-pixel gate from channel mean+max statistics."""
    kernel: int = 7

    @nn.compact
    def __call__(self, x):
        avg = jnp.mean(x, axis=-1, keepdims=True)
        mx = jnp.max(x, axis=-1, keepdims=True)
        a = nn.Conv(1, (self.kernel, self.kernel), padding="SAME")(
            jnp.concatenate([avg, mx], axis=-1))
        return x * nn.sigmoid(a)
