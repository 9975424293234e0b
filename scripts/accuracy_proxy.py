"""Accuracy proxy: train + evaluate odometry
quality end-to-end on the raycast synthetic world.

No real KITTI mounts in this environment, so this is the strongest
available stand-in for the reference's KITTI odometry benchmark
(/root/reference/rslo/utils/kitti_evaluation.py:97-238): a persistent
3D world rendered with occlusion/viewpoint/noise realism
(rslo_tpu/utils/world.py), written as a KITTI raw tree, pushed through
the PRODUCTION pipeline (create_hdf5 -> self-supervised train ->
evaluate) for each middle-net variant, reporting t_rel / r_rel / ATE
through the full KITTI evaluator.

What the held-out split actually tests: train
(seqs 0/1, "curve" trajectories at 8/11 m/s) and val (seq 7, "loop" at
8 m/s) are rendered from the SAME persistent world (one world_seed) by
the same generator family, so the val number measures generalization
across trajectory shape, viewpoints, occlusion patterns and motion
profile — NOT across scene content or sensor domain.  That is the
designed scope: the proxy exists to prove the training pipeline can
learn ego-motion end-to-end, not to predict real-KITTI scores.  For a
scene-generalization probe, build a second store with a different
--world_seed under a fresh RSLO_PROXY_ROOT, copy (or symlink) the
trained model dir into that root, and run eval there — the same
checkpoint scored against unseen scene content.

Stages (composable):
  python scripts/accuracy_proxy.py build                 # render + hdf5
  python scripts/accuracy_proxy.py train --middle PillarMiddleCov \
      --steps 3000 [--supervised]
  python scripts/accuracy_proxy.py eval --middle PillarMiddleCov
  python scripts/accuracy_proxy.py report                # table stdout

Artifacts under /tmp/rslo_proxy/ (tree, h5, model dirs, results json).
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

ROOT = Path(os.environ.get("RSLO_PROXY_ROOT", "/tmp/rslo_proxy"))
TREE = ROOT / "kitti_tree"
H5 = ROOT / "proxy.h5"

# seq id -> (frames, pattern, speed m/s).  Lengths sized so the
# standard KITTI 100-300 m segments fit (0.8-1.1 m/frame).
#
# RSLO_PROXY_SEQSET=v4 adds LOOP-pattern TRAINING sequences: r4's
# diag_yaw_head showed rotation IS learned on the oscillating-curve
# train windows (slope 0.64) but shrinks ~5x on the val loop —
# sustained one-direction turning is out of distribution.  v4 puts
# sustained turning (both directions: seq 2 ccw, seq 3 cw via the
# mirrored world trick below) in training.
if os.environ.get("RSLO_PROXY_SEQSET") == "v4":
    SEQS = {0: (350, "curve", 8.0), 1: (350, "curve", 11.0),
            2: (400, "loop", 9.5), 3: (400, "loop_cw", 7.0),
            7: (500, "loop", 8.0)}
    TRAIN_SEQS = (0, 1, 2, 3)
else:
    SEQS = {0: (350, "curve", 8.0), 1: (350, "curve", 11.0),
            7: (500, "loop", 8.0)}
    TRAIN_SEQS = (0, 1)
VAL_SEQS = (7,)


def base_cfg(middle: str, steps: int):
    from rslo_tpu.config.schema import PipelineCfg
    cfg = PipelineCfg()
    cfg = cfg.replace(
        middle=dataclasses.replace(cfg.middle, name=middle),
        data=dataclasses.replace(
            cfg.data, root=str(H5), train_sequences=TRAIN_SEQS,
            val_sequences=VAL_SEQS, eval_train_sequences=(0,),
            num_workers=2,
            # Magnitude diversity (train-time only): the proxy world
            # drives at constant per-sequence speed, which trains a
            # magnitude-compressed translation head (diag_pairtypes:
            # 1-step ratio 1.1, 2-step 0.69) — slerp pose interpolation
            # (sub-1x magnitudes) and random window stride break the
            # constant-speed prior.  skip=2 makes random_skip REAL
            # (with skip=1 the stride choice set is {1}): strides
            # {1,2} give super-1x magnitudes up to ~2.2 m.
            skip=2, random_skip=True, pose_interp_ratio=0.5,
            # Global-yaw aug: decorrelate absolute
            # scene heading from rotation targets — the remaining OOD
            # axis after v4 put sustained turning in training.
            yaw_aug_rad=float(np.pi),
            # Proxy frames are ~50k points: halve the cap and
            # int16-quantize (~3.9 mm rounding) -> ~4x less upload.
            max_points=65536, quantize_transfer=True),
        train=dataclasses.replace(cfg.train, steps=steps,
                                  steps_per_eval=max(steps // 4, 250),
                                  display_step=50),
        # Proxy-scale self-supervision schedule: the reference's
        # warmup_steps=1500 / icp_iter=2 are tuned for 200k-step runs
        # where a slow pseudo-target bootstrap is fine; at a few
        # thousand steps the warmup must shrink and the inner ICP must
        # correct most of the prediction error in ONE step (measured:
        # icp_iter=2 closes only ~60% of a 0.4 m error per step —
        # scripts/diag_pseudo.py).
        loss=dataclasses.replace(cfg.loss,
                                 warmup_steps=min(300, steps // 10),
                                 icp_iter=6),
    )
    return cfg


def cmd_build(args):
    """Render (optionally one seq per process: --seqs 0) + build hdf5."""
    from rslo_tpu.utils.world import write_kitti_tree
    TREE.mkdir(parents=True, exist_ok=True)
    seqs = (SEQS if args.seqs is None else
            {int(s): SEQS[int(s)] for s in args.seqs.split(",")})
    if not args.h5_only:
        gt = write_kitti_tree(TREE, seqs, world_seed=args.world_seed,
                              progress=True,
                              speed_profile=args.profile)
        np.savez(ROOT / f"gt_poses_{'_'.join(map(str, seqs))}.npz",
                 **{f"seq{k}": v[0] for k, v in gt.items()})
    if args.seqs is None or args.h5_only:
        from rslo_tpu.cli import main
        # --seqs + --h5_only builds a store restricted to those
        # sequences (e.g. a val-only store in a fresh RSLO_PROXY_ROOT
        # with a different --world_seed: the scene-generalization probe
        # — score a trained checkpoint against unseen scene content)
        main(["create_hdf5", "--kitti_root", str(TREE), "--out", str(H5),
              "--sequences", ",".join(str(s) for s in seqs)])
        print("proxy store ready:", H5, flush=True)


def _model_dir(middle, supervised, tag=""):
    t = middle + ("_sup" if supervised else "") + (f"_{tag}" if tag else "")
    return str(ROOT / f"model_{t}")


def cmd_train(args):
    from rslo_tpu.cli import main
    cfg = base_cfg(args.middle, args.steps)
    if getattr(args, "no_aug", False):
        # controlled-aug ablation (r4 rotation-collapse discriminator):
        # consecutive windows, no flip, no pose interpolation
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, skip=1, random_skip=False, pose_interp_ratio=0.0,
            random_flip_y=False, yaw_aug_rad=0.0))
    if getattr(args, "no_quantize", False):
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, quantize_transfer=False,
            max_points=131072))
    if args.remat is not None:
        cfg = cfg.replace(middle=dataclasses.replace(
            cfg.middle, remat=bool(args.remat)))
    if getattr(args, "steps_per_eval", None):
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, steps_per_eval=args.steps_per_eval))
    if args.engine:
        cfg = cfg.replace(middle=dataclasses.replace(
            cfg.middle, engine=args.engine))
    cfg_path = ROOT / f"train_{args.middle}.json"
    cfg_path.write_text(cfg.to_json())
    argv = ["train", "--config", str(cfg_path),
            "--model_dir", _model_dir(args.middle, args.supervised,
                                      args.tag)]
    if args.leg_until:
        argv += ["--leg_until", str(args.leg_until)]
    if args.supervised:
        argv.append("--supervised")
    if args.init_from:
        argv += ["--pretrained", args.init_from]
    main(argv)


def cmd_eval(args):
    from rslo_tpu.cli import main
    cfg = base_cfg(args.middle, 100)
    if args.engine:
        cfg = cfg.replace(middle=dataclasses.replace(
            cfg.middle, engine=args.engine))
    # eval walks CONSECUTIVE frames (the KITTI metric's semantics);
    # the train-time stride/interp knobs must not leak into val
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, skip=1, random_skip=False, pose_interp_ratio=0.0))
    cfg_path = ROOT / f"eval_{args.middle}.json"
    cfg_path.write_text(cfg.to_json())
    mdir = _model_dir(args.middle, args.supervised, args.tag)
    argv = ["evaluate", "--config", str(cfg_path), "--model_dir", mdir]
    if args.ckpt_step:
        argv += ["--ckpt_step", str(args.ckpt_step)]
    if args.refine:
        argv.append("--refine")
    if args.refine_loops:
        argv.append("--refine_loops")
        argv += ["--loop_min_separation", "40"]
    if getattr(args, "refine_ba", False):
        argv.append("--refine_ba")
    if getattr(args, "max_windows", None):
        argv += ["--max_windows", str(args.max_windows)]
    main(argv)
    # cmd_evaluate writes eval_results.json into the model dir
    res = json.loads((Path(mdir) / "eval_results.json").read_text())
    tag = args.middle + ("_sup" if args.supervised else "")
    if args.tag:
        tag += f"_{args.tag}"
    if args.ckpt_step:
        tag += f"_s{args.ckpt_step}"
    if args.refine:
        tag += "_refine"
    if args.refine_loops:
        tag += "_loops"
    if getattr(args, "refine_ba", False):
        tag += "_ba"
    if getattr(args, "max_windows", None):
        tag += f"_w{args.max_windows}"
    out = ROOT / f"result_{tag}.json"
    out.write_text(json.dumps(res, indent=1))
    print("saved", out, flush=True)


def cmd_report(args):
    rows = []

    def _mean(vals):
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None

    for f in sorted(ROOT.glob("result_*.json")):
        tag = f.stem[len("result_"):]
        res = json.loads(f.read_text())
        avg = res.get("avg")
        if avg is not None:
            rows.append((tag, avg.get("t_rel_pct"),
                         avg.get("r_rel_deg_per_100m"),
                         avg.get("ate_rmse_m")))
            continue
        # refined-eval layout: per-seq {chained, refined, loop_closed}
        seqs = [v for k, v in res.items() if k.startswith("seq_")]
        for mode in ("chained", "refined", "loop_closed"):
            sub = [s[mode] for s in seqs if mode in s]
            if not sub:
                continue
            rows.append((f"{tag}:{mode}",
                         _mean([m.get("t_rel_pct") for m in sub]),
                         _mean([m.get("r_rel_deg_per_100m")
                                for m in sub]),
                         _mean([m.get("ate_rmse_m") for m in sub])))
    print(f"{'variant':36s} {'t_rel %':>8s} {'r_rel d/100m':>12s} "
          f"{'ATE m':>8s}")
    for tag, t, r, a in rows:
        fmt = lambda v: "-" if v is None else f"{v:.3f}"
        print(f"{tag:36s} {fmt(t):>8s} {fmt(r):>12s} {fmt(a):>8s}")


def main():
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("--world_seed", type=int, default=0)
    b.add_argument("--seqs", default=None,
                   help="comma list; render only these (parallel use)")
    b.add_argument("--h5_only", action="store_true")
    b.add_argument("--profile", default="walk",
                   choices=("walk", "varied", "urban"),
                   help="speed profile; 'varied' = urban-drive "
                        "magnitude diversity (use a fresh "
                        "RSLO_PROXY_ROOT so v1 artifacts survive)")
    b.set_defaults(fn=cmd_build)
    t = sub.add_parser("train")
    t.add_argument("--middle", default="PillarMiddleCov")
    t.add_argument("--steps", type=int, default=3000)
    t.add_argument("--supervised", action="store_true")
    t.add_argument("--remat", type=int, default=None)
    t.add_argument("--engine", default=None,
                   help="middle engine override (rulebook|band|tiles)")
    t.add_argument("--tag", default="",
                   help="model-dir suffix for config experiments")
    t.add_argument("--leg_until", type=int, default=None)
    t.add_argument("--steps_per_eval", type=int, default=None,
                   help="periodic-eval interval override (evals are "
                        "cheap post-quantization: ~20 s)")
    t.add_argument("--no_quantize", action="store_true",
                   help="f32 transfer + 131072-pt cap (r2-equivalent "
                        "input path; quantization-suspect isolation)")
    t.add_argument("--no_aug", action="store_true",
                   help="skip=1, no flip/interp/random-skip (rotation-"
                        "collapse discriminator control)")
    t.add_argument("--init_from", default=None,
                   help="model dir to warm-start from (param surgery)")
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("eval")
    e.add_argument("--middle", default="PillarMiddleCov")
    e.add_argument("--supervised", action="store_true")
    e.add_argument("--refine", action="store_true")
    e.add_argument("--refine_loops", action="store_true")
    e.add_argument("--refine_ba", action="store_true",
                   help="geometric BA per window (pgo/ba_bridge); run "
                        "as its OWN eval — BA-refined pair motions "
                        "replace preds, so rows from a BA run are all "
                        "BA-influenced")
    e.add_argument("--max_windows", type=int, default=None)
    e.add_argument("--engine", default=None,
                   help="middle engine override (rulebook|band|tiles)")
    e.add_argument("--ckpt_step", default=None,
                   help="step number or 'best' (best_ckpt.json)")
    e.add_argument("--tag", default="")
    e.set_defaults(fn=cmd_eval)
    r = sub.add_parser("report")
    r.set_defaults(fn=cmd_report)
    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
