"""Spatial-grouped instance norm.

Port of the reference's SpatialGroupedInstanceNorm2d
(/root/reference/rslo/layers/normalization.py:265-335): the W (or H)
axis is split into ``groups`` spatial slabs; each (sample, row, slab,
channel) is instance-normalized over the slab's columns, with per-slab
affine parameters.  NHWC layout.
"""
from __future__ import annotations

import jax.numpy as jnp
from .. import nn


class SpatialGroupedInstanceNorm(nn.Module):
    """num_groups: (gH, gW) with one of them == 1 (reference constraint);
    the non-1 entry is the slab count along that axis."""
    num_groups: tuple = (1, 5)
    eps: float = 1e-5

    @nn.compact
    def __call__(self, x):
        gh, gw = self.num_groups
        assert gh == 1 or gw == 1
        transpose = gh > 1
        if transpose:
            x = jnp.swapaxes(x, 1, 2)   # normalize along H instead
            groups = gh
        else:
            groups = gw
        N, H, W, C = x.shape
        gsize = W // groups
        n_std = groups if W % groups == 0 else groups - 1
        last = W - n_std * gsize

        weight = self.param("weight", nn.initializers.ones, (groups, C))
        bias = self.param("bias", nn.initializers.zeros, (groups, C))

        def norm_slab(xs, w, b):
            # xs: (N, H, G, S, C): normalize over S per (N,H,G,C)
            mu = jnp.mean(xs, axis=3, keepdims=True)
            var = jnp.mean((xs - mu) ** 2, axis=3, keepdims=True)
            y = (xs - mu) / jnp.sqrt(var + self.eps)
            return y * w[None, None, :, None, :] + b[None, None, :, None, :]

        first = x[:, :, :W - last].reshape(N, H, n_std, gsize, C)
        first = norm_slab(first, weight[:n_std], bias[:n_std])
        first = first.reshape(N, H, W - last, C)
        if last > 0:
            tail = x[:, :, W - last:].reshape(N, H, 1, last, C)
            tail = norm_slab(tail, weight[n_std:], bias[n_std:])
            tail = tail.reshape(N, H, last, C)
            x = jnp.concatenate([first, tail], axis=2)
        else:
            x = first
        if transpose:
            x = jnp.swapaxes(x, 1, 2)
        return x
