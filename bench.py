"""Benchmark: steady-state two-frame odometry inference throughput on the
KITTI-scale workload (one GPU), for BOTH execution paths:

  * pillar  — PillarMiddleCov, the dense-2D middle;
  * sparse  — SparseMiddleCov, the reference-parity architecture
    (engine from the committed config default).

Needs a GPU; any failing stage fails the run.  Prints the card's name
and power limit, then ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "card": "...",
   "middle": "PillarMiddleCov", "sparse_fps": M, "sparse_engine": "..."}

The reference publishes no throughput numbers (SURVEY.md §6), so the
line carries absolute frames/s only.

Env: RSLO_BENCH_MIDDLE=PillarMiddleCov|SparseMiddleCov restricts to one
model (that model then provides the headline); RSLO_BENCH_ENGINE
overrides the sparse engine.
"""
import json
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import rslo_tpu.utils.jax_cache  # noqa: F401

import numpy as np


def bench_middle(middle: str, engine: str, n_iter: int = 16) -> float:
    """Steady-state two-frame forward fps for one middle config."""
    import jax
    import jax.numpy as jnp
    import dataclasses
    from rslo_tpu.config.schema import PipelineCfg
    from rslo_tpu.data.prepare import (prepare_example, voxelizer_config,
                                       mean_vfe_ok)
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.utils.synthetic import synth_sequence

    cfg = PipelineCfg()  # full KITTI-scale defaults
    mc = int(os.environ.get("RSLO_BAND_MIN_CHANNELS",
                            cfg.middle.band_min_channels))
    pl = os.environ.get("RSLO_PLAN_LOOKUP", cfg.middle.plan_lookup)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, seq_length=2),
        middle=dataclasses.replace(cfg.middle, name=middle,
                                   engine=engine, band_min_channels=mc,
                                   plan_lookup=pl))
    net = OdomNet(cfg)
    vcfg = voxelizer_config(cfg)

    frames, _ = synth_sequence(seed=0, n_frames=2,
                               n_points=cfg.data.max_points)
    pts = jnp.asarray(np.stack(frames))
    mask = jnp.ones(pts.shape[:2], bool)
    mean_mode = mean_vfe_ok(cfg)

    @jax.jit
    def forward(variables, pts, mask):
        ex = prepare_example(pts, mask, vcfg, mean_mode=mean_mode)
        return net.apply(variables, ex, train=False)["odometry"]

    t0 = time.time()
    example = jax.jit(
        lambda p, m: prepare_example(p, m, vcfg))(pts, mask)
    jax.block_until_ready(example)
    variables = jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), example, train=False)
    jax.block_until_ready(variables)
    print(f"# [{middle}/{engine}] init: {time.time()-t0:.1f}s",
          file=sys.stderr, flush=True)
    # steady state: each iterate voxelizes BOTH frames + full net
    # forward.  The K iterates are CHAINED device-side inside one jit
    # (inputs perturbed by the carry so XLA cannot CSE the chain) and
    # ONE reduction is fetched, so the number is device throughput
    # without per-frame host round trips.
    @jax.jit
    def chain(variables, pts, mask):
        def body(_, acc):
            ex = prepare_example(pts + acc * 1e-30, mask, vcfg,
                                 mean_mode=mean_mode)
            out = net.apply(variables, ex, train=False)["odometry"]
            return acc + jnp.sum(out.astype(jnp.float32))
        return jax.lax.fori_loop(0, n_iter, body, jnp.float32(0))

    t0 = time.time()
    np.asarray(forward(variables, pts, mask))
    print(f"# [{middle}/{engine}] forward compile: {time.time()-t0:.1f}s",
          file=sys.stderr, flush=True)
    t0 = time.time()
    np.asarray(chain(variables, pts, mask))
    print(f"# [{middle}/{engine}] chain compile: {time.time()-t0:.1f}s",
          file=sys.stderr, flush=True)
    t0 = time.time()
    np.asarray(chain(variables, pts, mask))
    dt = (time.time() - t0) / n_iter
    return 1.0 / dt  # one new frame per step in odometry streaming


def bench_streaming(middle: str, engine: str, T: int = 8,
                    n_iter: int = 4, cfg=None) -> float:
    """Deployment-shaped streaming throughput: each frame is voxelized
    and encoded ONCE and paired with the cached previous-frame BEV
    (eval/streaming.py semantics), chained over T frames inside one
    jitted lax.scan so the serial frame dependency is measured as pure
    device compute (the per-frame host fetch in a real deployment is a
    few floats)."""
    import jax
    import jax.numpy as jnp
    import dataclasses
    from rslo_tpu.config.schema import PipelineCfg
    from rslo_tpu.data.prepare import (prepare_example, voxelizer_config,
                                       mean_vfe_ok)
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.utils.synthetic import synth_sequence

    cfg = cfg or PipelineCfg()
    mc = int(os.environ.get("RSLO_BAND_MIN_CHANNELS",
                            cfg.middle.band_min_channels))
    pl = os.environ.get("RSLO_PLAN_LOOKUP", cfg.middle.plan_lookup)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, seq_length=2),
        middle=dataclasses.replace(cfg.middle, name=middle,
                                   engine=engine, band_min_channels=mc,
                                   plan_lookup=pl))
    net = OdomNet(cfg)
    vcfg = voxelizer_config(cfg)
    mean_mode = mean_vfe_ok(cfg)

    frames, _ = synth_sequence(seed=0, n_frames=T + 1,
                               n_points=cfg.data.max_points)
    pts = jnp.asarray(np.stack(frames))            # (T+1, N, 7)
    mask = jnp.ones(pts.shape[:2], bool)

    def features(variables, p, m):
        ex = prepare_example(p[None], m[None], vcfg, mean_mode=mean_mode)
        f = ex.get("voxel_features")
        if f is None:  # non-mean VFE config (streaming.py fallback)
            from rslo_tpu.models.vfe import simple_voxel_xyzi_normal
            f = simple_voxel_xyzi_normal(
                ex["voxels"][0], ex["num_points"][0],
                cfg.vfe.num_input_features)[None]
        return net.apply(variables, f[0], ex["coords"][0],
                         ex["voxel_mask"][0], False,
                         method=net.frame_features)[0]

    @jax.jit
    def stream(variables, pts, mask):
        bev0 = features(variables, pts[0], mask[0])

        def step(bev_prev, pm):
            p, m = pm
            bev = features(variables, p, m)
            preds = net.apply(variables, bev_prev, bev, False,
                              method=net.pair_predict)
            return bev, preds["odometry"][0]

        _, odom = jax.lax.scan(step, bev0, (pts[1:], mask[1:]))
        return odom.sum()                       # one scalar to fetch

    ex0 = jax.jit(lambda p, m: prepare_example(p, m, vcfg))(
        pts[:2], mask[:2])
    variables = jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), ex0, train=False)
    t0 = time.time()
    np.asarray(stream(variables, pts, mask))
    print(f"# [stream {middle}] compile: {time.time()-t0:.1f}s",
          file=sys.stderr, flush=True)
    t0 = time.time()
    for _ in range(n_iter):
        np.asarray(stream(variables, pts, mask))
    dt = (time.time() - t0) / (n_iter * T)
    return 1.0 / dt


def main():
    import subprocess
    import jax
    from rslo_tpu.config.schema import PipelineCfg
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"# card: {card}", file=sys.stderr, flush=True)
    only = os.environ.get("RSLO_BENCH_MIDDLE")
    sparse_engine = os.environ.get("RSLO_BENCH_ENGINE",
                                   PipelineCfg().middle.engine)
    rec = {}
    if only in (None, "PillarMiddleCov"):
        # the pillar middle has no sparse engine; pass the default
        rec["pillar"] = bench_middle("PillarMiddleCov",
                                     PipelineCfg().middle.engine)
    if only in (None, "SparseMiddleCov"):
        rec["sparse"] = bench_middle("SparseMiddleCov", sparse_engine)

    headline = "pillar" if "pillar" in rec else "sparse"
    fps = rec[headline]
    line = {
        "metric": "two_frame_odometry_inference",
        "value": round(fps, 3),
        "unit": "frames/s/gpu",
        "card": card,
        "middle": ("PillarMiddleCov" if headline == "pillar"
                   else "SparseMiddleCov"),
    }
    if "sparse" in rec and headline == "pillar":
        line["sparse_fps"] = round(rec["sparse"], 3)
        line["sparse_engine"] = sparse_engine
    if os.environ.get("RSLO_BENCH_STREAMING"):
        if only in (None, "PillarMiddleCov"):
            line["streaming_fps"] = round(
                bench_streaming("PillarMiddleCov",
                                PipelineCfg().middle.engine), 3)
        if only in (None, "SparseMiddleCov"):
            # deployment shape for the parity path too: each frame's
            # plans are built + encoded ONCE, reused by the next pair
            line["sparse_streaming_fps"] = round(
                bench_streaming("SparseMiddleCov", sparse_engine), 3)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
