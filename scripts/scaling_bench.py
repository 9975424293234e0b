"""Data-parallel scaling harness: same per-device batch on 1 vs N mesh
devices; reports step time and scaling efficiency (ideal = flat).

Without several GPUs it runs on the virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N, JAX_PLATFORMS=cpu)
to validate the psum path; on a multi-GPU host it measures the real
data-parallel efficiency.

Usage: python scripts/scaling_bench.py [n_devices_csv] (default 1,8)
"""
import dataclasses
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

import rslo_tpu.utils.jax_cache  # noqa: F401

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rslo_tpu.config.schema import (PipelineCfg, VoxelizerCfg, MiddleCfg,
                                    OdomCfg, LossCfg, DataCfg)
from rslo_tpu.models.net import OdomNet
from rslo_tpu.train.optim import build_optimizer
from rslo_tpu.train.state import TrainState
from rslo_tpu.train.step import make_train_step
from rslo_tpu.utils.synthetic import synth_sequence


def bench(n_devices: int, n_steps: int = 6):
    cfg = PipelineCfg(
        voxelizer=VoxelizerCfg(
            point_cloud_range=(-6.4, -6.4, -0.8, 6.4, 6.4, 0.8),
            voxel_size=(0.1, 0.1, 0.04), max_points_per_voxel=4,
            max_voxels=2048),
        middle=MiddleCfg(name="PillarMiddleCov",
                         level_capacities=(2048, 2048, 1024, 512),
                         channels=(8, 8, 16, 16)),
        odom=OdomCfg(num_input_features=32, layer_nums=(1, 1, 1),
                     num_filters=(16, 16, 32),
                     num_upsample_filters=(16, 16, 16),
                     bn_type="sync_bn"),
        loss=LossCfg(max_loss_points=2048),
        data=DataCfg(seq_length=2, max_points=8192),
    )
    devices = jax.devices()[:n_devices]
    mesh = Mesh(np.array(devices), ("data",))
    net = OdomNet(cfg)

    frames, gts = synth_sequence(seed=0, n_frames=2, n_points=8192)
    raw = {
        "points": jnp.asarray(np.stack(frames)),
        "point_mask": jnp.ones((2, 8192), bool),
        "odometry": jnp.asarray(gts[:1]),
    }
    batch = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_devices,) + x.shape), raw)
    batch = jax.device_put(batch, NamedSharding(mesh, P("data")))

    from rslo_tpu.data.prepare import prepare_example, voxelizer_config
    ex = prepare_example(raw["points"], raw["point_mask"],
                         voxelizer_config(cfg))
    ex["odometry"] = raw["odometry"]
    variables = jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), ex, train=False)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    state = TrainState.create(variables, tx, {"rot": -2.5, "trans": 0.0})
    state = jax.device_put(state, NamedSharding(mesh, P()))

    step = make_train_step(net, tx, cfg, mesh, warmup=True)
    state, m = step(state, batch)
    float(m["loss"])  # compile + barrier
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, m = step(state, batch)
        loss = float(m["loss"])
    dt = (time.perf_counter() - t0) / n_steps
    return dt, loss


if __name__ == "__main__":
    ns = [int(x) for x in (sys.argv[1].split(",") if len(sys.argv) > 1
                           else ["1", "8"])]
    base = None
    for n in ns:
        dt, loss = bench(n)
        if base is None:
            base = dt
        eff = base / dt
        print(f"devices={n}: {dt*1e3:.1f} ms/step (samples/s "
              f"{n/dt:.2f}, efficiency {eff*100:.0f}%) loss={loss:.3f}",
              flush=True)
