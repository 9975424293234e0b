"""Regression: PillarMiddleCov with bn_type="sync_bn" must produce
finite gradients under shard_map (flax's BatchNorm(axis_name=...)
gave NaN gradients there, hence the hand-rolled sync BN)."""
import dataclasses
import sys

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, "tests")


def test_pillar_syncbn_shardmap_grads_finite():
    from test_model import tiny_cfg
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.train.optim import build_optimizer
    from rslo_tpu.train.state import TrainState
    from rslo_tpu.train.step import make_train_step
    from rslo_tpu.utils.synthetic import synth_sequence
    from rslo_tpu.data.prepare import prepare_example, voxelizer_config

    cfg = tiny_cfg()
    cfg = cfg.replace(
        middle=dataclasses.replace(cfg.middle, name="PillarMiddleCov",
                                   bn_type="sync_bn"))
    net = OdomNet(cfg)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    frames, gts = synth_sequence(seed=5, n_frames=2, n_points=4000)
    scale = 6.0 / 60.0
    pts = np.stack(frames)
    pts[:, :, :2] *= scale
    pts[:, :, 2] = np.clip(pts[:, :, 2] * 0.2, -0.79, 0.79)
    gt = gts[:1].copy()
    gt[:, :3] *= scale
    raw = {
        "points": jnp.asarray(pts),
        "point_mask": jnp.ones((2, pts.shape[1]), bool),
        "odometry": jnp.asarray(gt),
    }
    batch = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), raw)
    batch = jax.device_put(batch, NamedSharding(mesh, P("data")))

    ex = prepare_example(raw["points"], raw["point_mask"],
                         voxelizer_config(cfg))
    ex["odometry"] = raw["odometry"]
    variables = net.init(jax.random.PRNGKey(0), ex, train=False)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    state = TrainState.create(variables, tx, {"rot": 0.0, "trans": 0.0})
    state = jax.device_put(state, NamedSharding(mesh, P()))

    step = make_train_step(net, tx, cfg, mesh, warmup=False,
                           self_supervised=False)
    state, m = step(state, batch)
    leaves = jax.tree.leaves(state.params)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves), \
        "non-finite params after sync_bn pillar step"
    assert np.isfinite(float(m["translation_loss"]))
    assert np.isfinite(float(m["rotation_loss"]))
    # batch stats must have actually updated (sync path executed)
    bs = jax.tree.leaves(state.batch_stats)
    assert bs and all(np.isfinite(np.asarray(l)).all() for l in bs)


def test_axis_present_helper():
    from jax.sharding import Mesh, PartitionSpec as P
    from rslo_tpu.utils.mesh_axis import axis_present

    assert not axis_present("data")
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    seen = {}

    def f(x):
        seen["data"] = axis_present("data")
        seen["bogus"] = axis_present("bogus")
        return jax.lax.pmean(x, "data")

    jax.shard_map(f, mesh=mesh, in_specs=P("data"), out_specs=P())(
        jnp.arange(2.0))
    assert seen == {"data": True, "bogus": False}
