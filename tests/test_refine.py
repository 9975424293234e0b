"""Windowed refinement: redundant noisy pair motions -> lower drift."""
import numpy as np
import jax.numpy as jnp

from rslo_tpu import geometry as G
from rslo_tpu.pgo.refine import (calibrate_pair_info,
                                 fuse_window_odometry,
                                 window_pairs_to_edges)


def make_trajectory(n=60, rng=None):
    odoms = np.zeros((n, 7), np.float32)
    odoms[:, 3] = 1.0
    odoms[1:, 0] = 1.0          # 1 m/frame forward
    odoms[1:, 6] = 0.01         # slight yaw per frame
    odoms[1:, 3] = np.sqrt(1 - 0.01 ** 2)
    return G.odom_to_abs_pose(odoms)


def test_fuse_reduces_noise(rng):
    gt_abs = make_trajectory(60)
    n = len(gt_abs)
    # windows of 3 frames, pair offsets (0,1), (0,2), (1,2)
    offsets = [(0, 1), (0, 2), (1, 2)]
    starts = list(range(0, n - 2))
    preds = []
    for s in starts:
        rowm = []
        for (i, j) in offsets:
            m = G.np_calc_vo(gt_abs[s + i:s + i + 1],
                             gt_abs[s + j:s + j + 1])[0]
            m = m.astype(np.float32)
            m[:3] += rng.normal(0, 0.03, 3)
            q_noise = np.asarray(G.qexp(jnp.asarray(
                rng.normal(0, 0.003, 3))), np.float32)
            m[3:] = np.asarray(G.qmult(jnp.asarray(m[3:]),
                                       jnp.asarray(q_noise)))
            rowm.append(m)
        preds.append(np.stack(rowm))
    preds = np.stack(preds)

    E, M, W = window_pairs_to_edges(starts, offsets, preds)
    refined = fuse_window_odometry(E, M, n, W, window=32, overlap=8,
                                   iters=8)

    # baseline: chain only the consecutive (i, i+1) edges
    chain = np.zeros((n, 7), np.float32)
    chain[:, 3] = 1.0
    lookup = {tuple(e): k for k, e in enumerate(E)}
    for i in range(n - 1):
        chain[i + 1] = M[lookup[(i, i + 1)]]
    chain_abs = G.odom_to_abs_pose(chain)

    err_chain = np.linalg.norm(chain_abs[-1, :3] - gt_abs[-1, :3])
    err_ref = np.linalg.norm(refined[-1, :3] - gt_abs[-1, :3])
    assert np.isfinite(err_ref)
    # redundant skip-2 edges must reduce endpoint drift
    assert err_ref < err_chain, (err_chain, err_ref)


def _noisy_preds(gt_abs, starts, offsets, rng, t_noise, r1_noise,
                 r2_noise):
    """Per-window pair measurements with offset-class rotation noise."""
    preds = []
    for s in starts:
        rowm = []
        for (i, j) in offsets:
            m = G.np_calc_vo(gt_abs[s + i:s + i + 1],
                             gt_abs[s + j:s + j + 1])[0].astype(np.float32)
            m[:3] += rng.normal(0, t_noise, 3)
            rn = r2_noise if (j - i) > 1 else r1_noise
            q_noise = np.asarray(G.qexp(jnp.asarray(
                rng.normal(0, rn, 3))), np.float32)
            m[3:] = np.asarray(G.qmult(jnp.asarray(m[3:]),
                                       jnp.asarray(q_noise)))
            rowm.append(m)
        preds.append(np.stack(rowm))
    return np.stack(preds)


def _mean_yaw_err_deg(refined, gt_abs):
    errs = []
    for i in range(len(refined) - 1):
        vo_p = G.np_calc_vo(refined[i:i + 1], refined[i + 1:i + 2])[0]
        vo_g = G.np_calc_vo(gt_abs[i:i + 1], gt_abs[i + 1:i + 2])[0]
        d = np.clip(abs(float(np.dot(vo_p[3:], vo_g[3:]))), 0, 1)
        errs.append(np.degrees(2 * np.arccos(d)))
    return float(np.mean(errs))


def test_calibration_degenerate_duplicates_fallback(rng):
    """Deterministic pair predictions make duplicate observations
    bit-identical (dup variance 0) — the calibration must reject that
    'evidence' and fall back to the asymmetric closure split instead
    of zeroing every multi-step edge (r5 eval: refined == chained)."""
    gt_abs = make_trajectory(60)
    offsets = [(0, 1), (0, 2), (1, 2)]
    starts = list(range(0, len(gt_abs) - 2))
    # per-PAIR noise keyed by the frame pair -> duplicates identical
    pair_noise = {}
    preds = []
    for s in starts:
        rowm = []
        for (i, j) in offsets:
            key = (s + i, s + j)
            if key not in pair_noise:
                m = G.np_calc_vo(gt_abs[key[0]:key[0] + 1],
                                 gt_abs[key[1]:key[1] + 1])[0].astype(
                                     np.float32)
                m[:3] += rng.normal(0, 0.03, 3)
                q_noise = np.asarray(G.qexp(jnp.asarray(
                    rng.normal(0, 0.01, 3))), np.float32)
                m[3:] = np.asarray(G.qmult(jnp.asarray(m[3:]),
                                           jnp.asarray(q_noise)))
                pair_noise[key] = m
            rowm.append(pair_noise[key].copy())
        preds.append(np.stack(rowm))
    preds = np.stack(preds)
    from rslo_tpu.pgo.refine import duplicate_pair_variance
    dup = duplicate_pair_variance(starts, offsets, preds)
    assert dup[0] is not None and dup[0] < 1e-10   # degenerate
    E, M, W = window_pairs_to_edges(starts, offsets, preds)
    info = calibrate_pair_info(E, M, W, dup_var=dup)
    span = E[:, 1] - E[:, 0]
    # multi-step edges keep REAL (nonzero) weight under the fallback
    t2 = np.median(info[span == 2, 0, 0] / W[span == 2])
    t1 = np.median(info[span == 1, 0, 0] / W[span == 1])
    r2 = np.median(info[span == 2, 3, 3] / W[span == 2])
    r1 = np.median(info[span == 1, 3, 3] / W[span == 1])
    assert t2 > 0.2 * t1, (t1, t2)
    assert 0.05 * r1 < r2 < 0.5 * r1, (r1, r2)


def test_calibrated_info_downweights_noisy_long_edges(rng):
    """Regression: when 2-step edges carry much
    noisier rotation, cycle-closure calibration must (a) assign them
    lower rotation information than 1-step edges and (b) stop the
    refinement from degrading per-frame rotation vs uniform info."""
    gt_abs = make_trajectory(60)
    n = len(gt_abs)
    offsets = [(0, 1), (0, 2), (1, 2)]
    starts = list(range(0, n - 2))
    preds = _noisy_preds(gt_abs, starts, offsets, rng,
                         t_noise=0.03, r1_noise=0.002, r2_noise=0.02)
    E, M, W = window_pairs_to_edges(starts, offsets, preds)
    from rslo_tpu.pgo.refine import duplicate_pair_variance
    dup = duplicate_pair_variance(starts, offsets, preds)
    assert dup[0] is not None
    info = calibrate_pair_info(E, M, W, dup_var=dup)
    span = E[:, 1] - E[:, 0]
    rot_info_1 = np.median(info[span == 1, 3, 3] / W[span == 1])
    rot_info_2 = np.median(info[span == 2, 3, 3] / W[span == 2])
    assert rot_info_2 < 0.5 * rot_info_1, (rot_info_1, rot_info_2)

    uniform = fuse_window_odometry(E, M, n, W, window=32, overlap=8,
                                   iters=8)
    calib = fuse_window_odometry(E, M, n, W, window=32, overlap=8,
                                 iters=8, pair_info=info)
    yaw_u = _mean_yaw_err_deg(uniform, gt_abs)
    yaw_c = _mean_yaw_err_deg(calib, gt_abs)
    assert yaw_c <= yaw_u * 1.02, (yaw_u, yaw_c)
    # translation must not regress materially either
    t_u = np.linalg.norm(uniform[-1, :3] - gt_abs[-1, :3])
    t_c = np.linalg.norm(calib[-1, :3] - gt_abs[-1, :3])
    assert t_c <= t_u * 1.5 + 0.5, (t_u, t_c)
