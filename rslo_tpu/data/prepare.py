"""Device-side example preparation: padded raw point clouds -> voxelized
model inputs.  Runs inside the same jit as the train/eval step — the
point->voxel scatter is device work, not host preprocessing (unlike the
reference, which voxelizes in C++ dataloader workers,
/root/reference/rslo/data/preprocess.py:469-512)."""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ..config.schema import PipelineCfg
from ..ops.voxelize import VoxelizerConfig, voxelize


def voxelizer_config(cfg: PipelineCfg) -> VoxelizerConfig:
    v = cfg.voxelizer
    return VoxelizerConfig(
        point_cloud_range=tuple(v.point_cloud_range),
        voxel_size=tuple(v.voxel_size),
        max_points=v.max_points_per_voxel,
        max_voxels=v.max_voxels,
        height_threshold=v.height_threshold,
        block_size=v.block_size,
    )


def dequantize_points(points: jax.Array) -> jax.Array:
    """Undo the loader's int16 transfer quantization (no-op on float
    inputs).  Scales are the static constants shared with
    data/loader.py::quantize_points."""
    if not jnp.issubdtype(points.dtype, jnp.integer):
        return points
    from .loader import quant_scale
    s = jnp.asarray(quant_scale(points.shape[-1]))
    return points.astype(jnp.float32) * s


def prepare_example(points: jax.Array, point_mask: jax.Array,
                    vcfg: VoxelizerConfig,
                    mean_mode: bool = False) -> Dict[str, jax.Array]:
    """points: (L, N, F) padded frames (f32, or int16 transfer-quantized
    — dequantized here); point_mask: (L, N) bool.
    Returns the voxelized example consumed by OdomNet (no batch dim).

    ``mean_mode`` emits pre-encoded per-voxel mean features directly
    (``voxel_features``) via ``voxelize_sorted_mean`` — the fast path
    for mean-style VFEs (the deployed SimpleVoxel_XYZINormalC): it
    skips the (V, P, F) point-list scatter and the VFE re-gather while
    producing identical features (same per-voxel point cap)."""
    from ..ops.voxelize import voxelize_sorted_mean
    points = dequantize_points(points)
    L = points.shape[0]
    if mean_mode:
        vox = [voxelize_sorted_mean(points[t], point_mask[t], vcfg)
               for t in range(L)]
        feats = []
        for v in vox:
            f = v.features
            if f.shape[1] >= 7:
                normal = f[:, 4:7]
                normal = normal / jnp.sqrt(
                    jnp.sum(normal * normal, -1, keepdims=True) + 1e-16)
                f = jnp.concatenate([f[:, :4], normal, f[:, 7:]], axis=-1)
            feats.append(f)
        return {
            "voxel_features": jnp.stack(feats),
            "num_points": jnp.stack([v.num_points for v in vox]),
            "coords": jnp.stack([v.coords for v in vox]),
            "voxel_mask": jnp.stack([v.mask for v in vox]),
        }
    vox = [voxelize(points[t], point_mask[t], vcfg) for t in range(L)]
    return {
        "voxels": jnp.stack([v.voxels for v in vox]),
        "num_points": jnp.stack([v.num_points for v in vox]),
        "coords": jnp.stack([v.coords for v in vox]),
        "voxel_mask": jnp.stack([v.mask for v in vox]),
    }


def mean_vfe_ok(cfg) -> bool:
    """True when the configured VFE is the plain per-voxel mean whose
    features voxelize_sorted_mean can emit directly (bit-equal, ~25%
    faster forward: skips the (V, P, F) list scatter + re-gather)."""
    return cfg.vfe.name == "SimpleVoxelXYZINormal"
