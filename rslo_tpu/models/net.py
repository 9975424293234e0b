"""Top-level odometry network: VFE -> sparse middle (+cov) -> BEV pair
encoder/decoder -> ego-motion vote.

Counterpart of the reference's UnVoxelOdomNetICP3
(/root/reference/rslo/models/voxel_odom_net.py:47-580): processes a
temporal window of ``seq_length`` voxelized frames with shared weights,
forms all C(L, 2) cyclic frame pairs, and returns the prediction pytree
consumed by the loss and eval layers.  One sample per device (the
reference asserts batch_size==1, middle.py:221); batching happens across
the device mesh.
"""
from __future__ import annotations

from typing import Any, Dict

import jax.numpy as jnp
from .. import nn

from ..config.schema import PipelineCfg, grid_size
from .bev_net import BEVOdomNet, cycle_pairs
from .middle import SparseMiddleCov, build_geometry
from . import vfe as _vfe  # noqa: F401  (registers the VFE encoders)


class OdomNet(nn.Module):
    cfg: PipelineCfg

    def setup(self):
        if self.cfg.middle.name == "PillarMiddleCov":
            from .middle_pillar import PillarMiddleCov
            cls = PillarMiddleCov
            static = (4,)  # train flag (arg 0 is the module)
            if self.cfg.middle.remat:
                cls = nn.remat(cls, static_argnums=static)
            self.middle = cls(self.cfg.middle, self.sparse_shape)
        else:
            cls = SparseMiddleCov
            if self.cfg.middle.remat:
                cls = nn.remat(cls, static_argnums=(3,))
            self.middle = cls(self.cfg.middle)
        self.bev_net = BEVOdomNet(self.cfg.odom,
                                  self.cfg.voxelizer.point_cloud_range)

    @property
    def sparse_shape(self):
        nx, ny, nz = grid_size(self.cfg.voxelizer)
        return (nz + 1, ny, nx)

    def __call__(self, example: Dict[str, Any], train: bool = False):
        """example (single sample, no batch dim):
          voxels:      (L, V, P, F) float
          num_points:  (L, V) int32
          coords:      (L, V, 3) int32 zyx (-1 padding)
          voxel_mask:  (L, V) bool
        Returns the prediction dict (all pair-major arrays)."""
        num_points = example["num_points"]
        coords = example["coords"]
        vmask = example["voxel_mask"]
        pre_encoded = "voxel_features" in example  # mean-mode prepare
        voxels = example.get("voxels")
        L = coords.shape[0]

        from ..config.registry import get as registry_get
        vfe_fn = registry_get("vfe", self.cfg.vfe.name)
        pillar_mode = self.cfg.middle.name == "PillarMiddleCov"
        bevs, covs, feats = [], [], []
        normal_gts = []
        for t in range(L):
            if pre_encoded:
                f = example["voxel_features"][t]
            else:
                f = vfe_fn(voxels[t], num_points[t],
                           self.cfg.vfe.num_input_features)
            if isinstance(f, tuple):   # NormalGT variant
                f, gt = f
                normal_gts.append(gt)
            if pillar_mode:
                bev, cov = self.middle(f, coords[t], vmask[t], train)
            else:
                geo = self._middle_geometry(coords[t], vmask[t])
                bev, cov = self.middle(f, geo, train)
            bevs.append(bev[None])   # add pair-batch axis (1, H, W, C)
            covs.append(cov)
            feats.append(f)

        x1, x2 = cycle_pairs(bevs)
        # spatial-partitioning hook: no-op unless tracing inside
        # parallel.spatial.make_spatial_forward (SP over grid width)
        from ..parallel.spatial import bev_constraint
        pair_in = bev_constraint(jnp.concatenate([x1, x2], axis=-1))
        preds = self.bev_net(pair_in, train)
        return self._finalize(preds, feats, covs, vmask, normal_gts, L)

    def _finalize(self, preds, feats, covs, vmask, normal_gts, L):

        preds["voxel_features"] = feats        # list[L] of (V, F)
        preds["voxel_covs"] = covs             # list[L] of (V, 7)
        preds["voxel_masks"] = [vmask[t] for t in range(L)]
        if normal_gts:
            preds["normal_gt"] = normal_gts    # cross-normal supervision
        preds["seq_length"] = L
        return preds

    # ---- streaming API ---------------------------------------------------
    # A production odometry stream encodes each frame ONCE and pairs it
    # with the cached previous frame's BEV features (the reference
    # always re-encodes both frames).

    def _middle_geometry(self, coords, vmask):
        """Build the engine-appropriate per-frame sparse geometry."""
        if self.cfg.middle.engine == "tiles":
            from .middle import build_tiled_geometry
            return build_tiled_geometry(coords, vmask, self.sparse_shape,
                                        self.cfg.middle.tile_capacities,
                                        tuple(self.cfg.middle.tile_shape))
        if self.cfg.middle.engine == "band":
            from .middle import build_band_geometry
            return build_band_geometry(
                coords, vmask, self.sparse_shape,
                self.cfg.middle.level_capacities,
                windows=tuple(self.cfg.middle.band_windows),
                block=self.cfg.middle.band_block,
                channels=tuple(self.cfg.middle.channels),
                min_channels=self.cfg.middle.band_min_channels,
                lookup=self.cfg.middle.plan_lookup)
        return build_geometry(coords, vmask, self.sparse_shape,
                              self.cfg.middle.level_capacities,
                              lookup=self.cfg.middle.plan_lookup)

    def frame_features(self, voxel_features, coords, vmask,
                       train: bool = False):
        """Encode one frame: (V, F) features + geometry -> (BEV, cov)."""
        if self.cfg.middle.name == "PillarMiddleCov":
            return self.middle(voxel_features, coords, vmask, train)
        return self.middle(voxel_features,
                           self._middle_geometry(coords, vmask), train)

    def pair_predict(self, bev_prev, bev_new, train: bool = False):
        """Predict the motion from the previous frame to the new one
        given their cached BEV features (H, W, C) each."""
        x = jnp.concatenate([bev_prev, bev_new], axis=-1)[None]
        return self.bev_net(x, train)
