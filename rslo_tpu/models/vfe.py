"""Voxel feature encoders ("Geometric Unit Feature Encoding", stage 1).

Equivalents of the reference VFE registry
(/root/reference/rslo/models/voxel_encoder.py).  The deployed encoder,
SimpleVoxel_XYZINormalC (voxel_encoder.py:258-280), is parameter-free:
per-voxel mean of the (x, y, z, intensity, nx, ny, nz) points with the
normal part re-normalized.  All variants are pure functions of the
static-shape voxel stacks.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config.registry import register_vfe


def _voxel_mean(voxels: jax.Array, num_points: jax.Array,
                n_feat: int) -> jax.Array:
    n = jnp.maximum(num_points, 1).astype(voxels.dtype)[:, None]
    return jnp.sum(voxels[:, :, :n_feat], axis=1) / n


@register_vfe("SimpleVoxelXYZINormal")
def simple_voxel_xyzi_normal(voxels: jax.Array, num_points: jax.Array,
                             num_input_features: int = 7) -> jax.Array:
    """(V, P, >=7) -> (V, 7): mean over valid points; cols 4:7 (normals)
    re-normalized to unit length."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    normal = m[:, 4:7]
    normal = normal / jnp.sqrt(
        jnp.sum(normal * normal, -1, keepdims=True) + 1e-16)
    return jnp.concatenate([m[:, :4], normal, m[:, 7:num_input_features]],
                           axis=-1)


@register_vfe("SimpleVoxelXYZNormal")
def simple_voxel_xyz_normal(voxels: jax.Array, num_points: jax.Array,
                            num_input_features: int = 6) -> jax.Array:
    """(V, P, >=6) -> (V, 6): mean with cols 3:6 re-normalized (the
    intensity-free variant, voxel_encoder.py:234-256)."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    normal = m[:, 3:6]
    normal = normal / jnp.sqrt(
        jnp.sum(normal * normal, -1, keepdims=True) + 1e-16)
    return jnp.concatenate([m[:, :3], normal], axis=-1)


@register_vfe("SimpleVoxel")
def simple_voxel(voxels: jax.Array, num_points: jax.Array,
                 num_input_features: int = 4) -> jax.Array:
    """Plain per-voxel mean (voxel_encoder.py:214-233)."""
    return _voxel_mean(voxels, num_points, num_input_features)


@register_vfe("SimpleVoxelXYZINormalNormalGT")
def simple_voxel_xyzi_normal_gt(voxels: jax.Array, num_points: jax.Array,
                                num_input_features: int = 10):
    """Cross-normal variant (voxel_encoder.py:282-312): columns 4:7 are
    the NETWORK-input normals, 7:10 are supervision normals.  Returns
    (features (V, 7), normal_gt (V, 3))."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    net_in = simple_voxel_xyzi_normal(voxels, num_points, 7)
    gt = m[:, 7:10]
    gt = gt / jnp.sqrt(jnp.sum(gt * gt, -1, keepdims=True) + 1e-16)
    return net_in, gt


@register_vfe("SimpleVoxelRadius")
def simple_voxel_radius(voxels: jax.Array, num_points: jax.Array,
                        num_input_features: int = 4) -> jax.Array:
    """Mean with the xy radius replacing x, y
    (voxel_encoder.py:377-405): [r, z, intensity, ...]."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    r = jnp.sqrt(jnp.sum(m[:, :2] ** 2, axis=-1, keepdims=True) + 1e-16)
    return jnp.concatenate([r, m[:, 2:num_input_features]], axis=-1)


@register_vfe("SimpleVoxelXYZINormalNormalize")
def simple_voxel_xyzi_normal_normalize(
        voxels: jax.Array, num_points: jax.Array,
        num_input_features: int = 7,
        pc_range=(-70.4, -38.4, -3.0, 70.4, 38.4, 5.0)) -> jax.Array:
    """Range-normalized mean encoder
    (voxel_encoder.py:313-341, SimpleVoxel_XYZINormalC_Normalize):
    xyz divided by the range maxima, intensity zeroed, normals
    re-normalized."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    hi = jnp.asarray(pc_range[3:6], m.dtype)
    xyz = m[:, :3] / hi
    normal = m[:, 4:7]
    normal = normal / jnp.sqrt(
        jnp.sum(normal * normal, -1, keepdims=True) + 1e-16)
    zero_i = jnp.zeros_like(m[:, 3:4])
    return jnp.concatenate([xyz, zero_i, normal,
                            m[:, 7:num_input_features]], axis=-1)


@register_vfe("SimpleVoxelBoundXYZINormal")
def simple_voxel_bound_xyzi_normal(voxels: jax.Array,
                                   num_points: jax.Array,
                                   num_input_features: int = 7
                                   ) -> jax.Array:
    """Boundary-point encoder (voxel_encoder.py:343-374,
    SimpleVoxel_BoundXYZINormalC): xyzi taken from the voxel's
    closest-to-sensor point (min range) instead of the mean; the
    normal (+extra) part stays the per-voxel mean, re-normalized.
    Padding rows are pushed to +inf range so they never win the min."""
    P = voxels.shape[1]
    valid = jnp.arange(P)[None, :] < jnp.maximum(num_points, 1)[:, None]
    rng2 = jnp.sum(voxels[:, :, :3] ** 2, axis=-1)
    rng2 = jnp.where(valid, rng2, jnp.inf)
    imin = jnp.argmin(rng2, axis=1)
    xyzi = jnp.take_along_axis(
        voxels[:, :, :4], imin[:, None, None].repeat(4, -1), axis=1)[:, 0]
    m = _voxel_mean(voxels, num_points, num_input_features)
    normal = m[:, 4:7]
    normal = normal / jnp.sqrt(
        jnp.sum(normal * normal, -1, keepdims=True) + 1e-16)
    return jnp.concatenate([xyzi, normal, m[:, 7:num_input_features]],
                           axis=-1)
