"""Pillar-style dense 2D middle extractor + per-voxel covariance head.

A re-design of the reference's sparse 3D middle net
(/root/reference/rslo/models/middle.py:36-245) as large regular 2D
convolutions instead of gather/scatter sparse 3D convolution with
per-frame rulebook builds.  This module keeps the middle net's exact output CONTRACT — a (H/8, W/8, 128)
BEV feature map plus 7 covariance params per active voxel — but computes
it dense-2D:

  * voxels collapse into per-pillar features: z-occupancy histogram
    (nz bins) + mean of the voxel features over the pillar → a dense
    (ny, nx, nz + F) image;
  * a 2D conv encoder with the reference's stride plan (1 -> 1/2 ->
    1/4 -> 1/8, channels 32/64/64/128) produces the BEV map;
  * a light 2D decoder upsamples 1/4-res features back to full res and
    a per-voxel head combines the pillar feature with the voxel's
    z-coordinate embedding to emit covariance params (one row gather per
    voxel — 40k rows, microseconds-scale).

Everything is bf16 with fp32 accumulation; no rulebooks, no sorts beyond
the voxelizer's.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from .. import nn

from ..config.schema import MiddleCfg


class Conv2dBNRelu(nn.Module):
    features: int
    stride: int = 1
    bn_type: str = "none"

    @nn.compact
    def __call__(self, x, train: bool):
        y = nn.Conv(self.features, (3, 3), strides=(self.stride,) * 2,
                    padding="SAME", dtype=jnp.bfloat16,
                    param_dtype=jnp.float32)(x)
        if self.bn_type != "none":
            # hand-rolled psum BN: flax nn.BatchNorm(axis_name=...)
            # produces NaN gradients under shard_map on this stack
            from .bev_net import Norm
            y = Norm(bn_type=self.bn_type)(y, train)
        return nn.relu(y)


class PillarMiddleCov(nn.Module):
    cfg: MiddleCfg
    sparse_shape: Tuple[int, int, int]   # (nz, ny, nx)

    @nn.compact
    def __call__(self, voxel_features: jax.Array, coords: jax.Array,
                 vmask: jax.Array, train: bool):
        """voxel_features: (V, F); coords: (V, 3) int32 zyx; vmask: (V,).
        Returns (bev (ny/8, nx/8, 128), cov_params (V, 7))."""
        nz, ny, nx = self.sparse_shape
        V, F = voxel_features.shape
        zbins = nz - 1  # drop the +1 headroom plane

        # ---- pillarize: scatter z-occupancy + mean features ------------
        py = jnp.where(vmask, coords[:, 1], ny)
        px = jnp.where(vmask, coords[:, 2], 0)
        pz = jnp.clip(coords[:, 0], 0, zbins - 1)
        occ = jnp.zeros((ny + 1, nx, zbins), jnp.float32)
        occ = occ.at[py, px, pz].add(1.0)
        feat_sum = jnp.zeros((ny + 1, nx, F), jnp.float32)
        feat_sum = feat_sum.at[py, px].add(
            jnp.where(vmask[:, None], voxel_features, 0.0))
        cnt = jnp.zeros((ny + 1, nx, 1), jnp.float32)
        cnt = cnt.at[py, px].add(vmask.astype(jnp.float32)[:, None])
        feat_mean = feat_sum / jnp.maximum(cnt, 1.0)
        # mean z position of occupied voxels per pillar (normalized)
        zsum = jnp.zeros((ny + 1, nx, 1), jnp.float32)
        zsum = zsum.at[py, px, 0].add(pz.astype(jnp.float32) *
                                      vmask.astype(jnp.float32))
        zmean = zsum / jnp.maximum(cnt, 1.0) / zbins

        pillar = jnp.concatenate(
            [occ[:ny], feat_mean[:ny], zmean[:ny], cnt[:ny] * 0.1],
            axis=-1).astype(jnp.bfloat16)[None]        # (1, ny, nx, C_in)

        c0, c1, c2, c3 = self.cfg.channels
        bnt = self.cfg.bn_type
        # encoder (stride plan mirrors the reference's resolution ladder)
        x = Conv2dBNRelu(2 * c1, 1, bnt)(pillar, train)
        x = Conv2dBNRelu(2 * c1, 1, bnt)(x, train)
        x_full = x
        x = Conv2dBNRelu(2 * c2, 2, bnt)(x, train)       # 1/2
        x = Conv2dBNRelu(2 * c2, 1, bnt)(x, train)
        x = Conv2dBNRelu(2 * c2, 2, bnt)(x, train)       # 1/4
        x = Conv2dBNRelu(2 * c2, 1, bnt)(x, train)
        x = Conv2dBNRelu(2 * c2, 1, bnt)(x, train)
        x_quarter = x
        x = Conv2dBNRelu(2 * c3, 2, bnt)(x, train)       # 1/8
        x = Conv2dBNRelu(2 * c3, 1, bnt)(x, train)
        bev = Conv2dBNRelu(2 * c3, 1, bnt)(x, train)     # (1,H/8,W/8,128)

        # ---- covariance decoder back to full res ----------------------
        y = x_quarter
        B, Hq, Wq, Cq = y.shape
        y = jax.image.resize(y, (B, Hq * 4, Wq * 4, Cq), method="nearest")
        y = jnp.concatenate([y, x_full], axis=-1)
        y = Conv2dBNRelu(c1, 1, bnt)(y, train)
        y = Conv2dBNRelu(c0, 1, bnt)(y, train)           # (1, ny, nx, c0)

        # per-voxel head: pillar feature at the voxel's (y, x) + z embed
        pfeat = y[0][coords[:, 1], coords[:, 2]].astype(jnp.float32)
        z_onehot = jax.nn.one_hot(pz // max(zbins // 8, 1), 8)
        h = jnp.concatenate([pfeat, z_onehot,
                             voxel_features.astype(jnp.float32)], axis=-1)
        h = nn.relu(nn.Dense(32)(h))
        cov = nn.Dense(self.cfg.cov_channels)(h)
        cov = jnp.concatenate(
            [nn.elu(cov[:, :3]) + 1 + 1e-6, cov[:, 3:]], axis=-1)
        cov = jnp.where(vmask[:, None], cov, 0.0)
        return bev[0].astype(jnp.float32), cov
