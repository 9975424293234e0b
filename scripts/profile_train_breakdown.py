"""Train-step cost breakdown by ablation.

The breakdown comes from separately-jitted ablations with host-fetch
barriers (the methodology the reference uses with its measure_time harness,
/root/reference/rslo/models/voxel_odom_net.py:241-278):

  voxelize            prepare_example only
  fwd (eval)          voxelize + full network forward
  step supervised     fwd + pose/pyramid losses + bwd + adamw update
  step self-sup       + consistency (chamfer/Mahalanobis/inner ICP)

Usage: python scripts/profile_train_breakdown.py [pillar|sparse] [L]
"""
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import rslo_tpu.utils.jax_cache  # noqa: F401

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rslo_tpu.config.schema import PipelineCfg
from rslo_tpu.data.prepare import prepare_example, voxelizer_config
from rslo_tpu.models.net import OdomNet
from rslo_tpu.train.optim import build_optimizer
from rslo_tpu.train.state import TrainState
from rslo_tpu.train.step import make_train_step
from rslo_tpu.utils.synthetic import synth_sequence


def bench(name, fn, *a, n=5):
    t0 = time.perf_counter()
    out = fn(*a)
    np.asarray(jax.tree.leaves(out)[0]).ravel()[:1]
    c = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*a)
        np.asarray(jax.tree.leaves(out)[0]).ravel()[:1]
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:24s} {dt:8.1f} ms  (compile {c:.0f}s)", flush=True)
    return dt


def main(middle: str, L: int):
    name = {"sparse": "SparseMiddleCov",
            "pillar": "PillarMiddleCov"}[middle]
    import os
    engine = os.environ.get("RSLO_MIDDLE_ENGINE")
    cfg = PipelineCfg()
    mid = dataclasses.replace(cfg.middle, name=name)
    if engine:
        mid = dataclasses.replace(mid, engine=engine)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, seq_length=L),
                      middle=mid)
    net = OdomNet(cfg)
    vcfg = voxelizer_config(cfg)
    frames, _ = synth_sequence(seed=0, n_frames=L,
                               n_points=cfg.data.max_points)
    n_pairs = L * (L - 1) // 2
    gt = np.zeros((n_pairs, 7), np.float32)
    gt[:, 3] = 1
    batch = {
        "points": jnp.asarray(np.stack(frames))[None],
        "point_mask": jnp.ones((1, L, cfg.data.max_points), bool),
        "odometry": jnp.asarray(gt)[None],
    }
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    ex = jax.jit(lambda p, m: prepare_example(p, m, vcfg))(
        batch["points"][0], batch["point_mask"][0])
    ex["odometry"] = batch["odometry"][0]
    variables = jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), ex, train=False)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    state = TrainState.create(variables, tx, {"rot": -2.5, "trans": 0.0})
    state = jax.device_put(state, NamedSharding(mesh, P()))
    batch = jax.device_put(batch, NamedSharding(mesh, P("data")))

    pts, pm = batch["points"][0], batch["point_mask"][0]
    t_vox = bench("voxelize (L frames)", jax.jit(
        lambda p, m: prepare_example(p, m, vcfg)), pts, pm)

    @jax.jit
    def fwd(v, p, m):
        e = prepare_example(p, m, vcfg)
        return net.apply(v, e, train=False)["odometry"]

    t_fwd = bench("fwd eval (L frames)", fwd, variables, pts, pm)

    # loss VALUE only (no grad): isolates the backward exactly as
    # (step self-sup) - (this) - (update overhead)
    from rslo_tpu.data.prepare import mean_vfe_ok
    from rslo_tpu.losses.objective import compute_objective
    pc_range = cfg.voxelizer.point_cloud_range
    mm = mean_vfe_ok(cfg)

    @jax.jit
    def loss_only(v, alphas, p, m, odom):
        e = prepare_example(p, m, vcfg, mean_mode=mm)
        e["odometry"] = odom
        preds, _ = net.apply(v, e, train=True, mutable=["batch_stats"])
        return compute_objective(preds, e, alphas, cfg.loss, pc_range,
                                 warmup=False,
                                 self_supervised=True).total

    t_loss = bench("fwd+loss self-sup (no bwd)", loss_only, variables,
                   {"rot": jnp.float32(-2.5), "trans": jnp.float32(0.0)},
                   pts, pm, batch["odometry"][0])

    def bench_step(name, step_fn, st, b, n=5):
        # the train step DONATES its state argument: chain the returned
        # state through the reps (one fetch per n steps)
        t0 = time.perf_counter()
        st, m = step_fn(st, b)
        np.asarray(m["loss"]).ravel()[:1]
        c = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            st, m = step_fn(st, b)
        np.asarray(m["loss"]).ravel()[:1]
        dt = (time.perf_counter() - t0) / n * 1e3
        print(f"{name:24s} {dt:8.1f} ms  (compile {c:.0f}s)", flush=True)
        return dt, st

    sup = make_train_step(net, tx, cfg, mesh, warmup=False,
                          self_supervised=False)
    t_sup, state = bench_step("step supervised", sup, state, batch)
    full = make_train_step(net, tx, cfg, mesh, warmup=False)
    t_full, state = bench_step("step self-supervised", full, state,
                               batch)
    print(f"\nderived: net fwd ~{t_fwd - t_vox:.0f} ms | "
          f"self-sup loss fwd ~{t_loss - t_fwd:.0f} ms | "
          f"backward+update ~{t_full - t_loss:.0f} ms | "
          f"supervised bwd+update ~{t_sup - t_fwd:.0f} ms | "
          f"consistency(+bwd) ~{t_full - t_sup:.0f} ms | "
          f"voxelize {t_vox:.0f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "pillar",
         int(sys.argv[2]) if len(sys.argv) > 2 else 3)
