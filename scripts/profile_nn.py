"""Chamfer NN search on the GPU: the Pallas kernel against XLA's scan,
alone and inside whole train steps; and the sparse forward with the band
engine against the rulebook engine.

    python scripts/profile_nn.py [--steps 10] [--out FILE]

Everything runs at the width of configs/kitti_train_ours.json on
synthetic scans.  Train steps alternate kernel, XLA, XLA, kernel; each
printed time carries the card's name and power limit.  A profiler trace
of a few kernel steps is reduced to device time per operation.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import rslo_tpu.utils.jax_cache  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rslo_tpu.cli import _synthetic_dataset  # noqa: E402
from rslo_tpu.config.schema import PipelineCfg  # noqa: E402
from rslo_tpu.data.loader import collate  # noqa: E402
from rslo_tpu.data.prepare import prepare_example, voxelizer_config  # noqa
from rslo_tpu.losses import consistency  # noqa: E402
from rslo_tpu.models.net import OdomNet  # noqa: E402
from rslo_tpu.ops import chamfer  # noqa: E402
from rslo_tpu.train.loop import data_mesh, shard_batch  # noqa: E402
from rslo_tpu.train.optim import build_optimizer  # noqa: E402
from rslo_tpu.train.state import TrainState  # noqa: E402
from rslo_tpu.train.step import make_train_step  # noqa: E402

CARD = ""   # nvidia-smi name and power limit, set in main()


def median_ms(f, reps):
    jax.block_until_ready(f())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def nn_alone(reps):
    from rslo_tpu.utils.synthetic import synth_sequence
    frames, _ = synth_sequence(seed=0, n_frames=2, n_points=20480)
    a = [jnp.asarray(frames[0][:, :3]), jnp.ones(20480, bool),
         jnp.asarray(frames[1][:, :3]), jnp.ones(20480, bool)]
    b = [jnp.stack([x] * 3) for x in a]
    out = {}
    for name, f in (("xla", chamfer.nn_search),
                    ("kernel", chamfer.nn_search_pallas)):
        f1, f3 = jax.jit(f), jax.jit(jax.vmap(f))
        out[name] = {"one_ms": median_ms(lambda: f1(*a), reps),
                     "vmap3_ms": median_ms(lambda: f3(*b), reps)}
        print(f"nn {name}: {out[name]} on {CARD}", flush=True)
    return out


def train_setup(cfg):
    net = OdomNet(cfg)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    mesh = data_mesh(1)
    b = collate([_synthetic_dataset(cfg, "train")[0]], cfg.data)
    b.pop("meta", None)
    ex0 = prepare_example(jnp.asarray(b["points"][0]),
                          jnp.asarray(b["point_mask"][0]),
                          voxelizer_config(cfg))
    variables = net.init(jax.random.PRNGKey(0), ex0, train=False)
    state = TrainState.create(variables, tx, {"rot": -2.5, "trans": 0.0})
    state = jax.tree.map(np.asarray, jax.device_get(state))
    return net, tx, mesh, shard_batch(b, mesh), state


def compile_step(cfg, net, tx, mesh, search, warmup, state, batch):
    """Train step compiled with ``search`` as the consistency loss's NN
    search."""
    saved = consistency.nn_search
    consistency.nn_search = search
    try:
        step = make_train_step(net, tx, cfg, mesh, warmup=warmup)
        return step.lower(state, batch).compile()
    finally:
        consistency.nn_search = saved


def time_steps(compiled, state, batch, n):
    state, _ = compiled(state, batch)          # warm
    jax.block_until_ready(state)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = compiled(state, batch)
        jax.block_until_ready(state)
        ts.append(time.perf_counter() - t0)
    return state, float(np.median(ts)) * 1e3, float(m["loss"])


def device_time_by_op(trace_dir: Path, top: int = 15):
    """Sum device event durations per name over the GPU planes."""
    from jax.profiler import ProfileData
    files = sorted(trace_dir.rglob("*.xplane.pb"))
    pd = ProfileData.from_file(str(files[-1]))
    tot, names = 0, {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                names[ev.name] = names.get(ev.name, 0) + ev.duration_ns
                tot += ev.duration_ns
    ranked = sorted(names.items(), key=lambda kv: -kv[1])[:top]
    return tot, ranked


def train_compare(cfg, steps, out_dir: Path):
    net, tx, mesh, batch, state0 = train_setup(cfg)
    from jax.sharding import NamedSharding, PartitionSpec as P
    res = {}
    for warmup in (False, True):
        state = jax.device_put(state0, NamedSharding(mesh, P()))
        t0 = time.perf_counter()
        k = compile_step(cfg, net, tx, mesh, chamfer.nn_search_pallas,
                         warmup, state, batch)
        ck = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = compile_step(cfg, net, tx, mesh, chamfer.nn_search, warmup,
                         state, batch)
        cx = time.perf_counter() - t0
        times = {"kernel": [], "xla": []}
        for name, c in (("kernel", k), ("xla", x), ("xla", x),
                        ("kernel", k)):
            state, ms, loss = time_steps(c, state, batch, steps)
            times[name].append(ms)
            print(f"train step warmup={warmup} nn={name}: {ms:.3f} ms "
                  f"(loss {loss:.4f}) on {CARD}", flush=True)
        res[f"warmup={warmup}"] = {"compile_s": {"kernel": ck, "xla": cx},
                                   "step_ms": times}
        if not warmup:
            trace = out_dir / "trace_train_step"
            jax.profiler.start_trace(str(trace))
            for _ in range(3):
                state, _m = k(state, batch)
            jax.block_until_ready(state)
            jax.profiler.stop_trace()
            tot, ranked = device_time_by_op(trace)
            res["trace_kernel_3_steps"] = {
                "device_ns": tot, "top": ranked}
            print(f"trace: {tot / 3e6:.3f} ms device time per step; top "
                  f"ops: {ranked[:8]}", flush=True)
    return res


def forward_engines(reps):
    """Two-frame forward of the sparse middle with each engine; both
    compiled first, then timed rulebook, band, band, rulebook."""
    base = PipelineCfg.from_json(
        (ROOT / "configs" / "kitti_train_ours.json").read_text())
    runs = {}
    for engine in ("rulebook", "band"):
        cfg = base.replace(
            data=dataclasses.replace(base.data, seq_length=2),
            middle=dataclasses.replace(base.middle, engine=engine))
        net = OdomNet(cfg)
        vcfg = voxelizer_config(cfg)
        b = collate([_synthetic_dataset(cfg, "val")[0]], cfg.data)
        pts, mask = jnp.asarray(b["points"][0]), jnp.asarray(
            b["point_mask"][0])
        variables = net.init(jax.random.PRNGKey(0),
                             prepare_example(pts, mask, vcfg), train=False)

        def fwd(variables, pts, mask, net=net, vcfg=vcfg):
            e = prepare_example(pts, mask, vcfg)
            return net.apply(variables, e, train=False)["odometry"]

        f = jax.jit(fwd).lower(variables, pts, mask).compile()
        runs[engine] = lambda f=f, a=(variables, pts, mask): f(*a)
    out = {"rulebook": [], "band": []}
    for engine in ("rulebook", "band", "band", "rulebook"):
        ms = median_ms(runs[engine], reps)
        out[engine].append(ms)
        print(f"sparse two-frame forward engine={engine}: {ms:.3f} ms on "
              f"{CARD}", flush=True)
    return out


def main():
    global CARD
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_nn: needs a GPU")
    CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default="profile_nn.json",
                   help="result JSON; the trace goes beside it")
    args = p.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    cfg = PipelineCfg.from_json(
        (ROOT / "configs" / "kitti_train_ours.json").read_text())
    res = {"card": CARD, "device": jax.devices()[0].device_kind}
    res["nn_alone"] = nn_alone(20)
    res["train"] = train_compare(cfg, args.steps, out.parent)
    res["forward_engines"] = forward_engines(10)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
