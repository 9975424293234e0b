"""Learned voxel feature encoders (PointNet-style VFE layers).

Flax ports of the reference's VoxelFeatureExtractor / V2
(/root/reference/rslo/models/voxel_encoder.py:29-211): per-point linear
-> norm -> relu, masked max-pool over the voxel's points, pointwise
concat of the pooled context, final linear + pool.  Points are augmented
with their offset from the voxel centroid (cluster center) like the
reference; masking uses the per-voxel point counts.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from .. import nn


def _point_mask(voxels: jax.Array, num_points: jax.Array) -> jax.Array:
    """(V, P, 1) validity from counts."""
    P = voxels.shape[1]
    ar = jnp.arange(P)[None, :]
    return (ar < num_points[:, None])[..., None].astype(voxels.dtype)


class VFELayer(nn.Module):
    out_features: int

    @nn.compact
    def __call__(self, x, mask, train: bool):
        half = self.out_features // 2
        h = nn.Dense(half, use_bias=False)(x)
        # per-feature norm over valid points (BatchNorm1d analog)
        n = jnp.sum(mask) * h.shape[-1] / mask.shape[-1] + 1e-6
        mu = jnp.sum(h * mask, axis=(0, 1)) / (jnp.sum(mask) + 1e-6)
        var = jnp.sum(((h - mu) * mask) ** 2, axis=(0, 1)) / \
            (jnp.sum(mask) + 1e-6)
        h = (h - mu) * jax.lax.rsqrt(var + 1e-3)
        h = nn.relu(h) * mask
        pooled = jnp.max(h + (mask - 1.0) * 1e9, axis=1, keepdims=True)
        pooled = jnp.broadcast_to(pooled, h.shape)
        return jnp.concatenate([h, pooled], axis=-1) * mask


class LearnedVFE(nn.Module):
    """VoxelFeatureExtractor: 2 VFE layers + linear + masked max-pool."""
    num_filters: Tuple[int, ...] = (32, 128)
    with_distance: bool = False

    @nn.compact
    def __call__(self, voxels: jax.Array, num_points: jax.Array,
                 train: bool = False) -> jax.Array:
        mask = _point_mask(voxels, num_points)
        n = jnp.maximum(num_points, 1).astype(voxels.dtype)[:, None, None]
        centroid = jnp.sum(voxels[..., :3] * mask, axis=1,
                           keepdims=True) / n
        feats = [voxels, (voxels[..., :3] - centroid) * mask]
        if self.with_distance:
            d = jnp.sqrt(jnp.sum(voxels[..., :3] ** 2, -1,
                                 keepdims=True) + 1e-16)
            feats.append(d * mask)
        x = jnp.concatenate(feats, axis=-1)
        for f in self.num_filters:
            x = VFELayer(f)(x, mask, train)
        x = nn.Dense(self.num_filters[-1])(x) * mask
        out = jnp.max(x + (mask - 1.0) * 1e9, axis=1)
        valid = (num_points > 0)[:, None]
        return jnp.where(valid, out, 0.0)
