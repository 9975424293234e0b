"""Miscellaneous small layers (reference rslo/layers/common.py parity)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .. import nn


def elu_plus(x, eps: float = 1e-12):
    """ELU + 1 (+eps): smooth positive map for scales/confidences
    (common.py ELUPlus)."""
    return nn.elu(x) + 1.0 + eps


def trunc_exp(x, max_value: float = 20.0):
    """exp with clipped input (common.py EXP truncation)."""
    return jnp.exp(jnp.clip(x, -max_value, max_value))


class ParameterLayer(nn.Module):
    """A bare learnable tensor (common.py ParameterLayer)."""
    shape: tuple
    init_value: float = 0.0

    @nn.compact
    def __call__(self):
        return self.param("value",
                          lambda k, s: jnp.full(s, self.init_value),
                          self.shape)


class Dropout2dGivenMask(nn.Module):
    """Channel dropout that can replay a given mask — used to drop the
    SAME channels in both frames of a pair (common.py
    Dropout2dGivenMask; odom_pred_base input_drop)."""
    rate: float

    @nn.compact
    def __call__(self, x, mask=None, deterministic: bool = True):
        if deterministic or self.rate <= 0.0:
            return x, jnp.ones(x.shape[:1] + (1, 1) + x.shape[-1:],
                               x.dtype)
        if mask is None:
            rng = self.make_rng("dropout")
            keep = jax.random.bernoulli(
                rng, 1.0 - self.rate,
                x.shape[:1] + (1, 1) + x.shape[-1:]).astype(x.dtype)
            mask = keep / (1.0 - self.rate)
        return x * mask, mask


def mask_propagate(mask, kernel: int = 3, stride: int = 1):
    """Standalone mask propagation (MaskPropagator analog)."""
    return nn.max_pool(mask, (kernel, kernel), (stride, stride),
                       padding="SAME")
