"""Evaluation driver: run two-frame inference over an ordered split,
chain odometries into trajectories, compute KITTI metrics.

The analog of /root/reference/evaluate.py:225-434 +
KittiDatasetHDF5.evaluation_seqs (kitti_dataset_hdf5.py:331-509), with
device batching over the mesh instead of NCCL all_gather.
"""
from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..config.schema import PipelineCfg
from ..data.loader import collate
from ..geometry import np_calc_vo, odom_to_abs_pose
from .kitti_odometry import evaluate_sequence


def run_eval(net, variables, dataset, cfg: PipelineCfg, mesh,
             eval_step, logger=None, max_windows: int | None = None,
             plot_dir: str | None = None) -> Dict[str, dict]:
    """eval_step: jitted (params, batch_stats, example_batch) ->
    (D, P, 7).  Iterates the ordered eval split; returns per-sequence
    metric dicts + aggregate."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    D = mesh.devices.size
    n = len(dataset) if max_windows is None else min(len(dataset),
                                                    max_windows)
    preds = np.zeros((n, 7), np.float32)
    gts = np.zeros((n, 7), np.float32)
    seq_ids = np.zeros((n,), np.int64)

    sharding = NamedSharding(mesh, P("data"))

    def host_prep(i):
        """HDF5 read + collate: CPU-bound, safe to run in threads (the
        training loader uses the same pattern)."""
        idxs = [min(i + d, n - 1) for d in range(D)]
        samples = [dataset[k] for k in idxs]
        batch = collate(samples, cfg.data)
        batch.pop("meta")
        return i, samples, batch

    def dispatch(prepped):
        i, samples, batch = prepped
        batch = jax.device_put(
            jax.tree.map(jnp.asarray, batch), sharding)
        out = eval_step(variables["params"],
                        variables.get("batch_stats", {}), batch)
        return i, samples, out

    def record(i, samples, out):
        out = np.asarray(out)
        for d in range(D):
            k = i + d
            if k >= n:
                break
            preds[k] = out[d, 0]
            gts[k] = samples[d]["odometry"][0]
            seq_ids[k] = samples[d]["seq"]

    # Warm-up outside the clock: the first dispatch pays the jit
    # compile, which would otherwise dominate and garble the reported
    # throughput.
    t_warm = time.time()
    record(*dispatch(host_prep(0)))
    t_warm = time.time() - t_warm
    t0 = time.time()

    # Two overlaps: a thread pool prefetches host-side sample prep
    # (reference's async dataloader, evaluate.py:225-434), and a
    # 3-deep dispatch pipeline hides the result fetch behind device
    # compute.
    import collections
    from concurrent.futures import ThreadPoolExecutor
    inflight = collections.deque()
    with ThreadPoolExecutor(max_workers=2) as pool:
        prep = collections.deque()
        nxt = D  # window 0 done in warm-up
        while nxt < n or prep or inflight:
            while nxt < n and len(prep) < 4:
                prep.append(pool.submit(host_prep, nxt))
                nxt += D
            while prep and prep[0].done() and len(inflight) < 3:
                inflight.append(dispatch(prep.popleft().result()))
            if not inflight:
                if prep:
                    inflight.append(dispatch(prep.popleft().result()))
                else:
                    break
            record(*inflight.popleft())
    elapsed = time.time() - t0
    if n > D:
        fps = (n - D) / max(elapsed, 1e-9)
    else:  # everything fit in the warm-up dispatch
        elapsed, fps = t_warm, n / max(t_warm, 1e-9)

    results: Dict[str, dict] = {"_meta": {"windows": n,
                                          "elapsed_s": elapsed,
                                          "frames_per_s": fps}}
    for s in np.unique(seq_ids):
        m = seq_ids == s
        pred_odoms = np.concatenate(
            [np.array([[0, 0, 0, 1, 0, 0, 0]], np.float32), preds[m]])
        gt_odoms = np.concatenate(
            [np.array([[0, 0, 0, 1, 0, 0, 0]], np.float32), gts[m]])
        pred_abs = odom_to_abs_pose(pred_odoms)
        gt_abs = odom_to_abs_pose(gt_odoms)
        entry = evaluate_sequence(pred_abs, gt_abs)
        # Frame-level odometry errors: the segment metrics chain poses
        # and are chaotic while per-frame error is still large, so the
        # steadier per-frame numbers are reported alongside.
        dt = np.linalg.norm(preds[m][:, :3] - gts[m][:, :3], axis=1)
        qd = np.abs(np.sum(preds[m][:, 3:] * gts[m][:, 3:], axis=1))
        qd /= np.maximum(np.linalg.norm(preds[m][:, 3:], axis=1), 1e-9)
        entry["frame_t_err_m"] = float(dt.mean())
        entry["frame_q_err_deg"] = float(np.mean(
            2 * np.arccos(np.clip(qd, 0.0, 1.0)) * 180.0 / np.pi))
        results[f"seq_{int(s):02d}"] = entry
        if plot_dir is not None:
            from .trajectory import draw_trajectory
            draw_trajectory(pred_abs, gt_abs, title=f"seq {int(s):02d}",
                            save_path=f"{plot_dir}/traj_{int(s):02d}.png")
    seq_keys = [k for k in results if k.startswith("seq_")]
    if seq_keys:
        results["avg"] = {
            "t_rel_pct": float(np.mean(
                [results[k]["t_rel_pct"] for k in seq_keys])),
            "r_rel_deg_per_100m": float(np.mean(
                [results[k]["r_rel_deg_per_100m"] for k in seq_keys])),
            "ate_rmse_m": float(np.mean(
                [results[k]["ate_rmse_m"] for k in seq_keys])),
            "frame_t_err_m": float(np.mean(
                [results[k]["frame_t_err_m"] for k in seq_keys])),
            "frame_q_err_deg": float(np.mean(
                [results[k]["frame_q_err_deg"] for k in seq_keys])),
        }
    if logger is not None:
        logger.log_text(f"eval: {n} windows in {elapsed:.1f}s "
                        f"({fps:.2f}/s)")
    return results


def run_eval_refined(net, variables, dataset, cfg: PipelineCfg, mesh,
                     eval_step, logger=None,
                     max_windows: int | None = None,
                     window: int = 64, overlap: int = 16,
                     iters: int = 8, use_ba: bool = False,
                     ba_points: int = 4096, use_loops: bool = False,
                     loop_min_separation: int = 50,
                     loop_score_threshold: float = 0.8,
                     loop_points: int = 4096,
                     eval_step_cov=None,
                     plot_dir: str | None = None) -> Dict[str, dict]:
    """Multi-frame-window eval + pose-graph refinement (driver config #4:
    the refine=True path).  Needs an eval split with seq_length >= 3 so
    windows contribute redundant (i, i+2) edges.

    ``use_ba`` additionally runs geometric bundle adjustment per window
    (pgo/ba_bridge.py): the window's point clouds are associated into
    landmark tracks under the predicted motions and the window poses are
    re-estimated by Schur-complement BA before the global fusion.  When
    ``eval_step_cov`` (make_eval_step(..., with_cov=True)) is supplied,
    BA consumes the NETWORK's voxel points with full 3x3
    covariance-whitened observations (cov_sqrt_info) — the reference's
    3D inherent error model (losses.py:422-437) driving the north-star
    refinement; otherwise raw clouds with unit weights.

    ``use_loops`` runs a loop-closure pass (pgo/loop_closure.py) over
    each sequence's fused trajectory: polar-descriptor place
    recognition, ICP loop edges, pose-graph re-optimization."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..pgo.refine import fuse_window_odometry, window_pairs_to_edges

    D = mesh.devices.size
    n = len(dataset) if max_windows is None else min(len(dataset),
                                                    max_windows)
    sample0 = dataset[0]
    L = len(sample0["points"])
    n_pairs = L * (L - 1) // 2
    offsets = [(i, j) for i in range(L) for j in range(i + 1, L)]

    preds = np.zeros((n, n_pairs, 7), np.float32)
    gts = np.zeros((n, n_pairs, 7), np.float32)
    seq_ids = np.zeros((n,), np.int64)
    starts = np.zeros((n,), np.int64)
    frame_clouds: Dict[tuple, np.ndarray] = {}

    def _keep_cloud(seq, frame, pts_raw):
        if not use_loops or (seq, frame) in frame_clouds:
            return
        p = np.asarray(pts_raw)[:, :3].astype(np.float32)
        step = max(1, len(p) // loop_points)
        p = p[::step][:loop_points]
        if len(p) < loop_points:   # pad by repetition: static ICP shapes
            p = np.concatenate(
                [p, p[np.arange(loop_points - len(p)) % len(p)]])
        frame_clouds[(seq, frame)] = p

    t0 = time.time()
    sharding = NamedSharding(mesh, P("data"))
    use_cov_ba = use_ba and eval_step_cov is not None
    i = 0
    while i < n:
        idxs = [min(i + d, n - 1) for d in range(D)]
        samples = [dataset[k] for k in idxs]
        batch = collate(samples, cfg.data)
        batch.pop("meta")
        batch = jax.device_put(jax.tree.map(jnp.asarray, batch), sharding)
        if use_cov_ba:
            out, vox_pts, vox_covs, vox_msk = eval_step_cov(
                variables["params"], variables.get("batch_stats", {}),
                batch)
            out = np.asarray(out)
            vox_pts = np.asarray(vox_pts)
            vox_covs = np.asarray(vox_covs)
            vox_msk = np.asarray(vox_msk)
        else:
            out = np.asarray(eval_step(variables["params"],
                                       variables.get("batch_stats", {}),
                                       batch))
        for d in range(D):
            k = i + d
            if k >= n:
                break
            preds[k] = out[d]
            gts[k] = samples[d]["odometry"]
            seq_ids[k] = samples[d]["seq"]
            starts[k] = samples[d]["frames"][0]
            for t, fr in enumerate(samples[d]["frames"]):
                _keep_cloud(samples[d]["seq"], int(fr),
                            samples[d]["points"][t])
            if use_ba:
                from ..geometry import np_calc_vo
                from ..pgo.ba_bridge import (cov_sqrt_info,
                                             refine_window_ba)
                consec = [preds[k][offsets.index((t, t + 1))]
                          for t in range(L - 1)]
                if use_cov_ba:
                    # network voxel centroids + full-covariance
                    # whitening from the uncertainty head
                    pts, wts = [], []
                    for t in range(L):
                        m = vox_msk[d, t]
                        p = vox_pts[d, t][m]
                        c = vox_covs[d, t][m]
                        step_n = max(1, len(p) // ba_points)
                        pts.append(p[::step_n][:ba_points])
                        wts.append(cov_sqrt_info(
                            c[::step_n][:ba_points]))
                    refined_poses = refine_window_ba(
                        pts, np.stack(consec), point_weights=wts)
                else:
                    pts = [np.asarray(samples[d]["points"][t])[:, :3]
                           [::max(1, len(samples[d]["points"][t]) //
                                  ba_points)]
                           for t in range(L)]
                    refined_poses = refine_window_ba(pts,
                                                     np.stack(consec))
                for p_i, (a, b) in enumerate(offsets):
                    preds[k][p_i] = np_calc_vo(
                        refined_poses[a][None], refined_poses[b][None])[0]
        i += D
    elapsed = time.time() - t0

    results: Dict[str, dict] = {"_meta": {"windows": n,
                                          "elapsed_s": elapsed,
                                          "refined": True}}
    for s in np.unique(seq_ids):
        m = seq_ids == s
        w_starts = starts[m]
        base = w_starts.min()
        w_starts = (w_starts - base).tolist()
        n_poses = max(w_starts) + L
        E, M, W = window_pairs_to_edges(w_starts, offsets, preds[m])
        # cycle-closure-calibrated per-class rot/trans information
        # (uniform info degraded refined r_rel vs chained)
        from ..pgo.refine import calibrate_pair_info, duplicate_pair_variance
        dup = duplicate_pair_variance(w_starts, offsets, preds[m])
        info = calibrate_pair_info(E, M, W, dup_var=dup)
        refined = fuse_window_odometry(E, M, n_poses, W, window=window,
                                       overlap=overlap, iters=iters,
                                       pair_info=info)
        # unrefined chain + GT trajectory from consecutive edges
        Eg, Mg, _ = window_pairs_to_edges(w_starts, offsets, gts[m])
        lookup = {tuple(e): k for k, e in enumerate(Eg)}
        gt_odoms = np.zeros((n_poses, 7), np.float32)
        gt_odoms[:, 3] = 1.0
        chain = gt_odoms.copy()
        lookup_p = {tuple(e): k for k, e in enumerate(E)}
        for f in range(n_poses - 1):
            kgt = lookup.get((f, f + 1))
            kpr = lookup_p.get((f, f + 1))
            if kgt is not None:
                gt_odoms[f + 1] = Mg[kgt]
            if kpr is not None:
                chain[f + 1] = M[kpr]
        gt_abs = odom_to_abs_pose(gt_odoms)
        chain_abs = odom_to_abs_pose(chain)
        entry = {
            "refined": evaluate_sequence(refined, gt_abs),
            "chained": evaluate_sequence(chain_abs, gt_abs),
        }
        variants = {"chained": chain_abs, "refined": refined}
        if use_loops:
            from ..geometry import np_compose_pose, np_invert_pose
            from ..pgo.loop_closure import close_loops
            have = [f for f in range(n_poses)
                    if (s, int(base) + f) in frame_clouds]
            if len(have) >= 2:
                # Loop-close over the subsequence of frames that have
                # clouds (all of them when windows are dense; the window
                # start/end keyframes when windows are strided), then
                # rigidly attach intermediate frames to the preceding
                # corrected keyframe.
                clouds = [frame_clouds[(s, int(base) + f)] for f in have]
                sub = refined[np.asarray(have)]
                r_odoms = np_compose_pose(np_invert_pose(sub[:-1]),
                                          sub[1:])
                # min_separation is in keyframe steps: rescale so the
                # temporal separation matches the dense-coverage case
                stride = max(1, (have[-1] - have[0]) //
                             max(1, len(have) - 1))
                sep = max(2, loop_min_separation // stride)
                lc_sub, cands = close_loops(
                    r_odoms, clouds,
                    min_separation=sep,
                    score_threshold=loop_score_threshold)
                lc_abs = refined.copy()
                for k, f in enumerate(have):
                    delta = np_compose_pose(
                        lc_sub[k][None],
                        np_invert_pose(refined[f][None]))[0]
                    f_end = have[k + 1] if k + 1 < len(have) else n_poses
                    for g in range(f, f_end):
                        lc_abs[g] = np_compose_pose(
                            delta[None], refined[g][None])[0]
                entry["loop_closed"] = evaluate_sequence(lc_abs, gt_abs)
                entry["n_loops"] = int(len(cands.pairs))
                entry["loop_keyframes"] = len(have)
                variants["loop_closed"] = lc_abs
            else:
                entry["n_loops"] = -1   # no clouds kept: skipped
                if logger is not None:
                    logger.log_text(
                        f"seq {int(s):02d}: loop closing skipped "
                        f"({len(have)} keyframe clouds)")
        if plot_dir is not None:
            from .trajectory import draw_trajectories
            draw_trajectories(variants, gt_abs,
                              title=f"seq {int(s):02d} (refined eval)",
                              save_path=f"{plot_dir}/traj_refined_"
                                        f"{int(s):02d}.png")
        results[f"seq_{int(s):02d}"] = entry
    if logger is not None:
        logger.log_text(f"refined eval: {n} windows in {elapsed:.1f}s")
    return results
