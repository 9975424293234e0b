"""The main path runs without flax, orbax, matplotlib and PIL: a tiny
train step, a checkpoint save/restore, image logging, a trajectory plot
and a streaming push, in a fresh interpreter where importing any of
those packages fails."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("flax", "orbax", "orbax.checkpoint", "matplotlib", "PIL"):
        sys.modules[name] = None          # import now raises ImportError
    sys.path[:0] = [{repo!r}, {tests!r}]
    import dataclasses, tempfile
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from test_model import tiny_cfg, make_example
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.train.optim import build_optimizer
    from rslo_tpu.train.state import TrainState
    from rslo_tpu.train.step import make_train_step
    from rslo_tpu.train.checkpoint import CheckpointManager
    from rslo_tpu.eval.streaming import StreamingOdometry
    from rslo_tpu.eval.trajectory import draw_trajectory
    from rslo_tpu.utils.logging import MetricLogger

    cfg = tiny_cfg()
    net = OdomNet(cfg)
    ex = make_example(np.random.default_rng(0), cfg)
    variables = net.init(jax.random.PRNGKey(0), ex, train=False)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    state = TrainState.create(variables, tx, {{"rot": 0.0, "trans": 0.0}})
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    step = make_train_step(net, tx, cfg, mesh, warmup=False,
                           self_supervised=False)
    batch = jax.tree.map(lambda x: x[None], ex)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    state, m = step(state, jax.device_put(batch,
                                          NamedSharding(mesh, P("data"))))
    assert np.isfinite(float(m["loss"]))

    d = tempfile.mkdtemp()
    mgr = CheckpointManager(d + "/ckpt")
    mgr.save(1, jax.device_get(state))
    back = mgr.restore(jax.device_get(state))
    assert int(back.step) == 1
    for a, b in zip(jax.tree.leaves(back.params),
                    jax.tree.leaves(jax.device_get(state.params))):
        np.testing.assert_array_equal(a, b)

    log = MetricLogger(d)
    log.log_image("img", np.zeros((4, 4), np.float32), 1)
    assert draw_trajectory(np.zeros((3, 7)), None) is None

    frames = np.random.default_rng(1).uniform(-6, 6, (2, 4000, 7))
    frames[..., 2] *= 0.1
    so = StreamingOdometry(net, {{"params": back.params,
                                  "batch_stats": back.batch_stats}}, cfg)
    poses = [so.push(f.astype(np.float32)) for f in frames]
    assert np.all(np.isfinite(poses[-1]))
    for name in ("flax", "orbax", "matplotlib", "PIL"):
        assert sys.modules[name] is None
    print("NO-OPTIONAL-DEPS OK")
""")


def test_main_path_without_optional_packages():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = SCRIPT.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "NO-OPTIONAL-DEPS OK" in r.stdout
