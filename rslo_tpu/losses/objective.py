"""Total training objective: pose + pyramid + self-supervised consistency.

Mirrors the reference's ``UnVoxelOdomNetICP3.loss``/``create_loss``
(/root/reference/rslo/models/voxel_odom_net.py:324-798) with the same
load-bearing schedules: before ``warmup_steps`` the consistency term sees
identity rotation / zero translation and runs ``warmup_icp_iter`` inner
ICP iterations; pseudo ego-motion targets are derived from the ICP-refined
predictions; pyramid tq-map targets are regenerated from the pseudo
targets each step.

The warmup phase is a *host-side static* decision (two jitted variants),
not traced control flow — the training loop knows the global step.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import jax
import jax.numpy as jnp

from ..config.schema import LossCfg
from ..geometry import generate_tq_map, hemisphere, matrix_to_quat, \
    quat_to_matrix
from .adaptive import adaptive_weighted_l2
from .consistency import consistency_loss_pairs


class LossOut(NamedTuple):
    total: jax.Array
    aux: Dict[str, jax.Array]


def _pair_indices(L: int):
    return [(i, j) for i in range(L) for j in range(i + 1, L)]


def compute_objective(preds: Dict[str, Any], example: Dict[str, Any],
                      alphas: Dict[str, jax.Array], cfg: LossCfg,
                      pc_range, *, warmup: bool,
                      self_supervised: bool = True) -> LossOut:
    """Args:
      preds: OdomNet output dict.
      example: batch example (odometry (P, 7) GT pair motions, used in
        supervised mode).
      alphas: {"rot": scalar, "trans": scalar} learned log-variances.
      warmup: static — True while global_step <= cfg.warmup_steps.
    """
    odom = preds["odometry"].astype(jnp.float32)       # (P, 7)
    T_pred, q_pred = odom[:, :3], odom[:, 3:]
    Ppairs = odom.shape[0]
    R_pred = quat_to_matrix(q_pred)

    aux: Dict[str, jax.Array] = {}
    res_R = res_t = None
    C_loss = jnp.float32(0.0)

    if self_supervised:
        L = preds["seq_length"]
        feats = preds["voxel_features"]   # list[L] (V, F)
        covs = preds["voxel_covs"]        # list[L] (V, 7)
        masks = preds["voxel_masks"]      # list[L] (V,)

        V = feats[0].shape[0]
        stride = max(1, -(-V // cfg.max_loss_points))  # ceil

        def sub(x):
            """Strided static subsample to <= max_loss_points rows
            (sorted-by-id voxels interleave spatially, so striding is a
            roughly uniform spatial subsample — the analog of the
            reference's pred_downsample_ratio)."""
            return x[::stride][:cfg.max_loss_points]

        def pts_of(t):
            f = sub(feats[t])
            if f.shape[1] > 6:
                return jnp.concatenate([f[:, 0:3], f[:, 4:7]], axis=-1)
            return f[:, 0:6]

        pairs = _pair_indices(L)
        use_hier = cfg.use_hier_points and "hier_points" in example
        if use_hier:
            # hier-points fallback (voxel_odom_net.py:654): consistency
            # runs on the offline hierarchical clouds (xyz + normals)
            # with NO covariance modeling.
            from ..data.prepare import dequantize_points
            hp = dequantize_points(
                example["hier_points"]).astype(jnp.float32)  # (L, Nh, 6)
            hm = example["hier_mask"]                        # (L, Nh)
            Nh = hp.shape[1]
            stride_h = max(1, -(-Nh // cfg.max_loss_points))

            def subh(x):
                return x[::stride_h][:cfg.max_loss_points]

            src_pts = jnp.stack([subh(hp[i]) for (i, j) in pairs])
            src_mask = jnp.stack([subh(hm[i]) for (i, j) in pairs])
            tgt_pts = jnp.stack([subh(hp[j]) for (i, j) in pairs])
            tgt_mask = jnp.stack([subh(hm[j]) for (i, j) in pairs])
            src_cov = tgt_cov = None
        else:
            src_list, tgt_list = [], []
            for (i, j) in pairs:
                src_list.append((pts_of(i), sub(masks[i]), sub(covs[i])))
                tgt_list.append((pts_of(j), sub(masks[j]), sub(covs[j])))

            src_pts = jnp.stack([s[0] for s in src_list])   # (P, V, 6)
            src_mask = jnp.stack([s[1] for s in src_list])
            src_cov = jnp.stack([s[2] for s in src_list])
            tgt_pts = jnp.stack([t[0] for t in tgt_list])
            tgt_mask = jnp.stack([t[1] for t in tgt_list])
            tgt_cov = jnp.stack([t[2] for t in tgt_list])

        icp_iter = cfg.warmup_icp_iter if warmup else cfg.icp_iter

        # cross-normal mode: the finer supervision normals weight the
        # association instead of the network-input normals
        # (voxel_odom_net.py:602-607)
        if "normal_gt" in preds and not use_hier:
            gts = preds["normal_gt"]
            src_normals = jnp.stack([sub(gts[i]) for (i, j) in pairs])
        else:
            src_normals = src_pts[..., 3:6]

        # Per-pyramid-level consistency loop (voxel_odom_net.py:670-725):
        # each level's odometry vote warps the clouds and contributes a
        # weighted consistency term; the ICP corrections COMPOSE across
        # levels.  The deployed config emits a single level (the main
        # vote), reducing to one application with weight 1.
        levels = preds.get("odometry_levels") or [odom]
        weights = cfg.pyramid_level_weights[-len(levels):]
        C_raw_sum = jnp.float32(0.0)
        res_R = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                                 (Ppairs, 3, 3))
        res_t = jnp.zeros((Ppairs, 3), jnp.float32)
        for lvl, w_lvl in zip(levels, weights):
            lvl = lvl.astype(jnp.float32)
            if warmup:
                R_use = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                                         (Ppairs, 3, 3))
                T_use = jnp.zeros((Ppairs, 3), jnp.float32)
            else:
                R_use = quat_to_matrix(lvl[:, 3:])
                T_use = lvl[:, :3]
            # Warp target clouds by this level's motion (xyz only; the
            # normal channels feed the cosine weighting from SRC side).
            tgt_xyz = jnp.einsum(
                'pij,pnj->pni', R_use, tgt_pts[..., :3],
                precision=jax.lax.Precision.HIGHEST) + T_use[:, None, :]
            c_raw, rR, rt = consistency_loss_pairs(
                src_pts[..., :3], src_mask,
                jax.lax.stop_gradient(src_normals), src_cov,
                tgt_xyz, tgt_mask, tgt_cov, R_use, T_use,
                penalize_ratio=cfg.penalize_ratio,
                reg_weight=cfg.reg_weight, icp_iter=icp_iter)
            C_raw_sum = C_raw_sum + w_lvl * c_raw
            # compose: res_ = r @ res_ ; res_t = r @ res_t + t
            res_t = jnp.einsum('pij,pj->pi', rR, res_t,
                               precision=jax.lax.Precision.HIGHEST) + rt
            res_R = jnp.einsum('pij,pjk->pik', rR, res_R,
                               precision=jax.lax.Precision.HIGHEST)
        C_loss = cfg.consistency_weight * C_raw_sum
        aux["consistency_loss"] = C_raw_sum

        # Pseudo targets from the composed ICP correction applied to the
        # FINAL level's prediction (voxel_odom_net.py:727-735)
        R_base = jax.lax.stop_gradient(R_use)
        T_base = jax.lax.stop_gradient(T_use)
        R_tgt = res_R @ R_base
        q_tgt = hemisphere(matrix_to_quat(R_tgt))
        t_tgt = jnp.einsum('pij,pj->pi', res_R, T_base,
                           precision=jax.lax.Precision.HIGHEST) + res_t
        rotation_targets = jax.lax.stop_gradient(q_tgt)
        translation_targets = jax.lax.stop_gradient(t_tgt)
    else:
        gt = example["odometry"].astype(jnp.float32).reshape(-1, 7)
        translation_targets = gt[:, :3]
        rotation_targets = hemisphere(gt[:, 3:])

    T_loss = adaptive_weighted_l2(T_pred, translation_targets,
                                  alphas["trans"],
                                  focal_gamma=cfg.focal_gamma,
                                  weight=cfg.translation_weight)
    R_loss = adaptive_weighted_l2(q_pred, rotation_targets, alphas["rot"],
                                  focal_gamma=cfg.focal_gamma,
                                  weight=cfg.rotation_weight)

    # ---- pyramid (deep supervision) losses ------------------------------
    pyramid = preds.get("pyramid", [])
    pyramid_loss = jnp.float32(0.0)
    if pyramid:
        tq_targets = jnp.concatenate(
            [translation_targets, rotation_targets], axis=-1)
        H, W = pyramid[-1][0].shape[1:3]
        tgt_map = generate_tq_map(tq_targets, (H, W), pc_range)  # (P,H,W,7)
        tgt_map = jax.lax.stop_gradient(tgt_map)
        n = len(pyramid)
        for i, (pmap, pmask) in enumerate(pyramid):
            h, w = pmap.shape[1:3]
            tm = tgt_map
            if (h, w) != (H, W):
                tm = jax.image.resize(tgt_map, (Ppairs, h, w, 7),
                                      method="nearest")
            t_l = adaptive_weighted_l2(
                pmap[..., :3], tm[..., :3], alphas["trans"],
                mask=pmask[..., 0:1], focal_gamma=cfg.focal_gamma,
                weight=cfg.pyramid_translation_weight)
            r_l = adaptive_weighted_l2(
                pmap[..., 3:], tm[..., 3:], alphas["rot"],
                mask=pmask[..., -1:], focal_gamma=cfg.focal_gamma,
                weight=cfg.pyramid_rotation_weight)
            w_i = cfg.pyloss_exp_w_base ** (n - i)
            pyramid_loss = pyramid_loss + w_i * (t_l + r_l)

    # Diagnostic-only odometry error vs the (never-trained-on in
    # self-supervised mode) GT motions: the total
    # loss can fall on regularizers alone, so convergence must be
    # judged against pose error, not loss.
    if "odometry" in example:
        gt = jax.lax.stop_gradient(
            example["odometry"].astype(jnp.float32).reshape(-1, 7))
        if gt.shape[0] == Ppairs:
            aux["t_err_gt"] = jnp.mean(jnp.sqrt(
                jnp.sum((T_pred - gt[:, :3]) ** 2, -1) + 1e-12))
            qn = q_pred / jnp.sqrt(
                jnp.sum(q_pred * q_pred, -1, keepdims=True) + 1e-12)
            dq = jnp.abs(jnp.sum(qn * hemisphere(gt[:, 3:]), -1))
            aux["q_err_deg"] = jnp.mean(
                2 * jnp.arccos(jnp.clip(dq, 0.0, 1.0)) * 180.0 / jnp.pi)

    total = T_loss + R_loss + pyramid_loss + C_loss
    aux.update({
        "translation_loss": T_loss,
        "rotation_loss": R_loss,
        "pyramid_loss": pyramid_loss,
        "C_loss": C_loss,
        "loss": total,
    })
    return LossOut(total, aux)
