"""Streaming odometry runner: per-frame feature caching.

The deployment-shaped inference loop: each incoming scan is voxelized
and encoded ONCE; its BEV features pair with the cached previous
frame's features for the motion prediction.  One jitted step carries
(points, mask, bev_prev) -> (odometry, bev_new), where the two-frame
stateless path re-encodes both frames.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config.schema import PipelineCfg
from ..data.prepare import prepare_example, voxelizer_config
from ..geometry import np_compose_pose


class StreamingOdometry:
    def __init__(self, net, variables, cfg: PipelineCfg):
        self.net = net
        self.variables = variables
        self.cfg = cfg
        vcfg = voxelizer_config(cfg)

        from ..data.prepare import mean_vfe_ok
        mean_mode = mean_vfe_ok(cfg)

        def _features(variables, pts, mask):
            ex = prepare_example(pts[None], mask[None], vcfg,
                                 mean_mode=mean_mode)
            f = ex.get("voxel_features")
            if f is None:
                from ..models.vfe import simple_voxel_xyzi_normal
                f = simple_voxel_xyzi_normal(
                    ex["voxels"][0], ex["num_points"][0],
                    cfg.vfe.num_input_features)[None]
            return net.apply(
                variables, f[0], ex["coords"][0], ex["voxel_mask"][0],
                False, method=net.frame_features)

        def _step(variables, pts, mask, bev_prev):
            bev_new, cov = _features(variables, pts, mask)
            preds = net.apply(variables, bev_prev, bev_new, False,
                              method=net.pair_predict)
            return preds["odometry"][0], bev_new

        self._features = jax.jit(_features)
        self._step = jax.jit(_step)
        self._bev = None
        self.pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
        self.trajectory = [self.pose.copy()]

    def push(self, points: np.ndarray,
             mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Feed one scan (N, F); returns the current absolute pose."""
        pts = jnp.asarray(points)
        m = (jnp.ones(pts.shape[:1], bool) if mask is None
             else jnp.asarray(mask))
        if self._bev is None:
            self._bev, _ = self._features(self.variables, pts, m)
            return self.pose
        odom, self._bev = self._step(self.variables, pts, m, self._bev)
        odom = np.asarray(odom)
        self.pose = np_compose_pose(self.pose[None], odom[None])[0]
        self.trajectory.append(self.pose.copy())
        return self.pose
