"""Command-line entry points.

The analog of the reference's fire-based CLI
(/root/reference/train_hdf5.py:891-893, evaluate.py:437-438):

    python -m rslo_tpu.cli create_hdf5 --kitti_root ... --out all.h5
    python -m rslo_tpu.cli train --config cfg.json --model_dir runs/x
    python -m rslo_tpu.cli evaluate --config cfg.json --model_dir runs/x
    python -m rslo_tpu.cli bench

``--synthetic`` swaps the KITTI store for the generated scene (smoke
tests / benches without mounted data).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np


def _load_cfg(path: str | None):
    from .config.schema import PipelineCfg
    if path is None:
        return PipelineCfg()
    return PipelineCfg.from_json(Path(path).read_text())


def _synthetic_dataset(cfg, split: str, n_windows: int = 64):
    """Dataset-shaped object over the synthetic scene."""
    from .utils.synthetic import synth_sequence
    from .data.dataset import generate_cyc_vo
    from .geometry import np_compose_pose

    L = cfg.data.seq_length if split == "train" else 2
    pr = cfg.voxelizer.point_cloud_range
    # scale the synthetic scene to the configured range so tiny test
    # configs still get meaningful voxel occupancy
    scale = min(abs(pr[0]), abs(pr[1]), pr[3], pr[4]) / 60.0
    zscale = min(abs(pr[2]), pr[5]) / 3.0

    class SynthDataset:
        def __len__(self):
            return n_windows

        def __getitem__(self, idx):
            frames, gts = synth_sequence(seed=idx, n_frames=L,
                                         n_points=cfg.data.max_points)
            if scale < 0.99:
                frames = [f.copy() for f in frames]
                for f in frames:
                    f[:, :2] *= scale
                    f[:, 2] = (f[:, 2] + 1.7) * zscale - 0.5 * zscale
                gts = gts.copy()
                gts[:, :2] *= scale
                gts[:, 2] *= zscale
            poses = [np.array([0, 0, 0, 1, 0, 0, 0], np.float32)]
            for g in gts:
                poses.append(np_compose_pose(poses[-1], g))
            poses = np.stack(poses)
            return {
                "points": frames,
                "pose_seq": poses,
                "odometry": generate_cyc_vo(poses),
                "seq": 0,
                "frames": list(range(idx, idx + L)),
            }

    return SynthDataset()


def update_best_checkpoint(model_dir, step_i: int, avg: dict):
    """NaN-proof best-checkpoint selection (reference eval_once model
    selection, train_hdf5.py:790-807).  Primary key t_rel_pct,
    fallback frame_t_err_m when segment metrics are unavailable
    (average_errors deliberately returns NaN for too-short
    trajectories, eval/kitti_odometry.py:81-90 — NaN must never pin
    the best record).

    Returns the (metric_name, value) written, or None if not better.
    """
    import math

    def _finite(x):
        try:
            return x is not None and math.isfinite(float(x))
        except (TypeError, ValueError):
            return False

    if _finite(avg.get("t_rel_pct")):
        key_name, key = "t_rel_pct", float(avg["t_rel_pct"])
    elif _finite(avg.get("frame_t_err_m")):
        key_name, key = "frame_t_err_m", float(avg["frame_t_err_m"])
    else:
        return None  # nothing finite to rank on

    best_p = Path(model_dir) / "best_ckpt.json"
    prev = json.loads(best_p.read_text()) if best_p.exists() else None
    if prev is None or not _finite(prev.get("metric")):
        better = True  # replace missing or NaN-poisoned records
    elif prev.get("metric_name") != key_name:
        # metric availability changed; the primary key wins outright
        better = key_name == "t_rel_pct"
    else:
        better = key < float(prev["metric"])
    if not better:
        return None
    best_p.write_text(json.dumps(
        {"step": int(step_i), "metric": key, "metric_name": key_name,
         "avg": {k: float(v) for k, v in avg.items()}}))
    return key_name, key


def cmd_create_hdf5(args):
    from .data.hdf5_store import create_hdf5
    create_hdf5(args.kitti_root, args.out,
                sequences=[int(s) for s in args.sequences.split(",")],
                cross_normal_radius=args.cross_normal_radius,
                max_frames=args.max_frames)


def cmd_train(args):
    import jax
    from .config.schema import PipelineCfg
    from .data.dataset import KittiWindowDataset
    from .data.loader import DataLoader
    from .train.distributed import initialize_multihost, is_rank0
    from .train.loop import Trainer, data_mesh
    from .data.prepare import prepare_example, voxelizer_config
    import jax.numpy as jnp

    initialize_multihost()
    cfg = _load_cfg(args.config)
    if args.steps:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    steps=args.steps))
    mesh = data_mesh()
    trainer = Trainer(cfg, args.model_dir, mesh,
                      self_supervised=not args.supervised,
                      rank0=is_rank0())
    trainer.logger.log_text(f"config:\n{cfg.to_json()}")

    if args.synthetic:
        dataset = _synthetic_dataset(cfg, "train")
    else:
        dataset = KittiWindowDataset(cfg.data, "train")
    D = mesh.devices.size
    # resume the data stream where the checkpoint left it (the
    # reference's last_iter = global_step - 1, train_hdf5.py:535-536)
    resume_step = trainer.ckpt.latest_step() or 0
    loader = DataLoader(dataset, cfg.data, D, cfg.train.steps,
                        train=True, seed=cfg.train.seed,
                        last_iter=resume_step - 1)

    # init from one real batch (shapes must match the stream)
    first = next(iter(loader))
    first.pop("meta", None)
    vcfg = voxelizer_config(cfg)
    ex0 = prepare_example(jnp.asarray(first["points"][0]),
                          jnp.asarray(first["point_mask"][0]), vcfg)
    ex0["odometry"] = jnp.asarray(first["odometry"][0])
    state = trainer.init_state(
        ex0, pretrained=args.pretrained,
        pretrained_include=args.pretrained_include,
        pretrained_exclude=args.pretrained_exclude)

    def batches():
        yield first
        for b in loader:
            yield b

    # periodic eval during training (reference eval_once,
    # train_hdf5.py:790-807)
    if args.synthetic:
        eval_ds = _synthetic_dataset(cfg, "val", n_windows=16)
    else:
        try:
            # KITTI metrics are over CONSECUTIVE frames: the periodic
            # val walk pins skip=1 even when training uses a larger
            # window stride (random_skip magnitude diversity)
            eval_ds = KittiWindowDataset(
                dataclasses.replace(cfg.data, skip=1), "val",
                seq_length=2)
        except Exception:
            eval_ds = None

    def eval_hook(tr, st, step_i):
        if eval_ds is None:
            return
        from .eval.runner import run_eval
        variables = {"params": st.params, "batch_stats": st.batch_stats}
        res = run_eval(tr.net, variables, eval_ds, cfg, mesh,
                       tr.eval_fn(), tr.logger, max_windows=256,
                       plot_dir=f"{args.model_dir}/plots/step_{step_i}")
        if "avg" in res:
            tr.logger.log_metrics({"eval": res["avg"]}, step_i)
            # best-checkpoint tracking: evaluate --ckpt_step best reads
            # this back (NaN-proof selection, see update_best_checkpoint)
            written = update_best_checkpoint(args.model_dir, step_i,
                                             res["avg"])
            if written is not None:
                tr.ckpt.preserve(step_i)  # survive max_to_keep pruning
                tr.logger.log_text(
                    f"new best checkpoint: step {step_i} "
                    f"({written[0]}={written[1]:.3f})")
        # image observability (the reference's tq-map/conf/mask images,
        # train_hdf5.py:749-787)
        try:
            import numpy as _np
            preds = tr.net.apply(variables, ex0, train=False)
            tq = _np.asarray(preds["tq_map"][0], _np.float32)
            tr.logger.log_image("tq_map/translation_norm",
                                _np.linalg.norm(tq[..., :3], axis=-1),
                                step_i)
            tr.logger.log_image("conf/translation",
                                _np.asarray(preds["t_conf"][0, ..., 0]),
                                step_i)
            tr.logger.log_image("conf/rotation",
                                _np.asarray(preds["q_conf"][0, ..., 0]),
                                step_i)
            tr.logger.log_image("feature_mask",
                                _np.asarray(preds["input_mask"][0, ..., 0],
                                            _np.float32), step_i)
        except Exception as e:  # never let viz kill training
            tr.logger.log_text(f"image logging failed: {e}")

    state = trainer.fit(batches(), state, eval_hook=eval_hook,
                        max_steps=args.leg_until or args.steps)
    trainer.logger.log_text(f"done at step {int(state.step)}")


def cmd_evaluate(args):
    import jax.numpy as jnp
    from .data.dataset import KittiWindowDataset
    from .eval.runner import run_eval, run_eval_refined
    from .train.distributed import initialize_multihost, is_rank0
    from .train.loop import Trainer, data_mesh

    initialize_multihost()
    cfg = _load_cfg(args.config)
    mesh = data_mesh()
    trainer = Trainer(cfg, args.model_dir, mesh, rank0=is_rank0())
    seq_len = 3 if (args.refine or args.refine_ba or
                    args.refine_loops) else 2
    if args.synthetic:
        cfg2 = cfg.replace(data=dataclasses.replace(cfg.data,
                                                    seq_length=seq_len))
        dataset = _synthetic_dataset(
            cfg2, "train" if seq_len == 3 else "val", n_windows=32)
    else:
        dataset = KittiWindowDataset(cfg.data, "val", seq_length=seq_len)
    sample = dataset[0]
    from .data.loader import collate
    from .data.prepare import prepare_example, voxelizer_config
    vcfg = voxelizer_config(cfg)
    b0 = collate([sample], cfg.data)
    ex0 = prepare_example(jnp.asarray(b0["points"][0]),
                          jnp.asarray(b0["point_mask"][0]), vcfg)
    ex0["odometry"] = jnp.asarray(b0["odometry"][0])
    ckpt_step = args.ckpt_step
    if ckpt_step == "best":
        best_p = Path(args.model_dir) / "best_ckpt.json"
        if not best_p.exists():
            raise SystemExit("--ckpt_step best: no best_ckpt.json in "
                             f"{args.model_dir} (train with periodic "
                             "eval first)")
        best = json.loads(best_p.read_text())
        ckpt_step = int(best["step"])
        trainer.logger.log_text(
            f"evaluating best checkpoint: step {ckpt_step} "
            f"({best['metric_name']}={best['metric']:.3f})")
    elif ckpt_step is not None:
        ckpt_step = int(ckpt_step)
    state = trainer.init_state(ex0, ckpt_step=ckpt_step)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    if args.refine or args.refine_ba or args.refine_loops:
        results = run_eval_refined(
            trainer.net, variables, dataset, cfg, mesh,
            trainer.eval_fn(), trainer.logger,
            max_windows=args.max_windows, use_ba=args.refine_ba,
            use_loops=args.refine_loops,
            loop_min_separation=args.loop_min_separation,
            loop_score_threshold=args.loop_score_threshold,
            eval_step_cov=(trainer.eval_fn(with_cov=True)
                           if args.refine_ba else None),
            plot_dir=str(Path(args.model_dir) / "plots"))
    else:
        results = run_eval(trainer.net, variables, dataset, cfg, mesh,
                           trainer.eval_fn(), trainer.logger,
                           max_windows=args.max_windows,
                           plot_dir=str(Path(args.model_dir) / "plots"))
    print(json.dumps(results, indent=2, default=str))
    out = Path(args.model_dir) / "eval_results.json"
    out.write_text(json.dumps(results, indent=1, default=str))


def cmd_bench(args):
    import runpy
    runpy.run_path(str(Path(__file__).resolve().parents[1] / "bench.py"),
                   run_name="__main__")


def main(argv=None):
    p = argparse.ArgumentParser(prog="rslo_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create_hdf5")
    c.add_argument("--kitti_root", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--sequences", default=",".join(str(i)
                                                   for i in range(11)))
    c.add_argument("--max_frames", type=int, default=None)
    c.add_argument("--cross_normal_radius", type=float, default=None,
                   help="also store coarser-scale normals "
                        "(lidar_cross_normals) for the crossnorm dataset")
    c.set_defaults(fn=cmd_create_hdf5)

    t = sub.add_parser("train")
    t.add_argument("--config", default=None)
    t.add_argument("--model_dir", required=True)
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--leg_until", type=int, default=None,
                   help="stop this process at the given step while the "
                        "LR schedule/loader still span the full --steps "
                        "run (leg-restart pattern for long trainings: "
                        "each leg exits at a checkpoint boundary and "
                        "the next process resumes)")
    t.add_argument("--synthetic", action="store_true")
    t.add_argument("--supervised", action="store_true")
    t.add_argument("--pretrained", default=None,
                   help="warm-start from another run's model dir "
                        "(shape-matching leaves only)")
    t.add_argument("--pretrained_include", default=None)
    t.add_argument("--pretrained_exclude", default=None)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate")
    e.add_argument("--config", default=None)
    e.add_argument("--model_dir", required=True)
    e.add_argument("--synthetic", action="store_true")
    e.add_argument("--max_windows", type=int, default=None)
    e.add_argument("--ckpt_step", default=None,
                   help="evaluate a specific checkpoint step, or 'best' "
                        "(periodic-val model selection via "
                        "best_ckpt.json; default: latest)")
    e.add_argument("--refine", action="store_true")
    e.add_argument("--refine_ba", action="store_true",
                   help="refine with geometric bundle adjustment "
                        "(landmark tracks from the raw clouds)")
    e.add_argument("--refine_loops", action="store_true",
                   help="close trajectory loops (polar-descriptor "
                        "place recognition + ICP edges + pose graph)")
    e.add_argument("--loop_min_separation", type=int, default=50)
    e.add_argument("--loop_score_threshold", type=float, default=0.8)
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("bench")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
