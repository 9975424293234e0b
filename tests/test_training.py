"""Training mechanics: supervised loss decreases over steps on a fixed
batch (full train step through shard_map on the 8-device mesh)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@pytest.mark.slow
def test_supervised_training_decreases_loss():
    import sys
    sys.path.insert(0, "tests")
    from test_model import tiny_cfg
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.train.optim import build_optimizer
    from rslo_tpu.train.state import TrainState
    from rslo_tpu.train.step import make_train_step
    from rslo_tpu.utils.synthetic import synth_sequence

    cfg = tiny_cfg()
    cfg = cfg.replace(
        middle=dataclasses.replace(cfg.middle, name="PillarMiddleCov"),
        optimizer=dataclasses.replace(cfg.optimizer, lr_max=3e-3),
        train=dataclasses.replace(cfg.train, steps=50))
    net = OdomNet(cfg)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    frames, gts = synth_sequence(seed=3, n_frames=2, n_points=4000)
    pr = cfg.voxelizer.point_cloud_range
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

    from rslo_tpu.data.prepare import prepare_example, voxelizer_config
    ex = prepare_example(raw["points"], raw["point_mask"],
                         voxelizer_config(cfg))
    ex["odometry"] = raw["odometry"]
    variables = net.init(jax.random.PRNGKey(0), ex, train=False)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    state = TrainState.create(variables, tx, {"rot": 0.0, "trans": 0.0})
    state = jax.device_put(state, NamedSharding(mesh, P()))

    step = make_train_step(net, tx, cfg, mesh, warmup=False,
                           self_supervised=False)
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["translation_loss"]) +
                      float(m["rotation_loss"]))
    assert np.isfinite(losses).all()
    # supervised pose loss on a fixed batch must drop substantially
    # (averaged over 5 steps: the trajectory oscillates under the
    # OneCycle lr peak, so single steps are noisy)
    assert np.mean(losses[-5:]) < np.mean(losses[:3]) - 0.5, losses[:5] + \
        losses[-5:]


@pytest.mark.slow
def test_selfsup_training_reduces_pose_error():
    """Self-supervised training must REDUCE the diagnostic GT pose
    errors (objective aux t_err_gt / q_err_deg) — the cheap CPU guard
    against round 2's failure mode, where frame_t_err WORSENED over a
    10k-step self-sup run while the loss kept falling.
    Uses the production two-phase schedule: identity-R warmup steps,
    then the ICP pseudo-target phase."""
    import sys
    sys.path.insert(0, "tests")
    from test_model import tiny_cfg
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.train.optim import build_optimizer
    from rslo_tpu.train.state import TrainState
    from rslo_tpu.train.step import make_train_step
    from rslo_tpu.utils.synthetic import synth_sequence

    cfg = tiny_cfg()
    cfg = cfg.replace(
        middle=dataclasses.replace(cfg.middle, name="PillarMiddleCov"),
        optimizer=dataclasses.replace(cfg.optimizer, lr_max=3e-3),
        train=dataclasses.replace(cfg.train, steps=80))
    net = OdomNet(cfg)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    frames, gts = synth_sequence(seed=3, n_frames=2, n_points=4000)
    scale = 6.0 / 60.0
    pts = np.stack(frames)
    pts[:, :, :2] *= scale
    pts[:, :, 2] = np.clip(pts[:, :, 2] * 0.2, -0.79, 0.79)
    gt = gts[:1].copy()
    gt[:, :3] *= scale
    # forward-biased half-plane mask: the scaled scene is dominated by
    # its rotation-symmetric ground disk, which gives ICP a second
    # global minimum at 180 deg yaw (observed: q_err converging to
    # ~179 deg while translation improved).  A forward-facing crop
    # makes rotation identifiable.
    pmask = pts[:, :, 0] > -1.0
    raw = {
        "points": jnp.asarray(pts),
        "point_mask": jnp.asarray(pmask),
        "odometry": jnp.asarray(gt),
    }
    batch = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), raw)
    batch = jax.device_put(batch, NamedSharding(mesh, P("data")))

    from rslo_tpu.data.prepare import prepare_example, voxelizer_config
    ex = prepare_example(raw["points"], raw["point_mask"],
                         voxelizer_config(cfg))
    ex["odometry"] = raw["odometry"]
    variables = net.init(jax.random.PRNGKey(0), ex, train=False)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    state = TrainState.create(variables, tx, {"rot": 0.0, "trans": 0.0})
    state = jax.device_put(state, NamedSharding(mesh, P()))

    wstep = make_train_step(net, tx, cfg, mesh, warmup=True,
                            self_supervised=True)
    step = make_train_step(net, tx, cfg, mesh, warmup=False,
                           self_supervised=True)
    terrs, qerrs = [], []
    for i in range(60):
        state, m = (wstep if i < 15 else step)(state, batch)
        terrs.append(float(m["t_err_gt"]))
        qerrs.append(float(m["q_err_deg"]))
    assert np.isfinite(terrs).all() and np.isfinite(qerrs).all()
    # GT is never trained on in self-sup mode: these are honest held-out
    # diagnostics.  Probed (deterministic CPU): t 1.24 -> 0.009 m,
    # q 121 -> 0.7 deg; 0.3x margins absorb last-ulp numeric shifts
    # (e.g. scatter-add order) while still catching the round-2 failure
    # mode of pose error not improving under self-supervision.
    assert np.mean(terrs[-5:]) < 0.3 * np.mean(terrs[:3]), (
        terrs[:3], terrs[-5:])
    assert np.mean(qerrs[-5:]) < 0.3 * np.mean(qerrs[:3]), (
        qerrs[:3], qerrs[-5:])
