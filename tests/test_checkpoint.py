"""Checkpoint manager: save / latest / restore round-trip + pruning."""
import numpy as np
import pytest
import jax.numpy as jnp
import optax

from rslo_tpu.train.checkpoint import CheckpointManager
from rslo_tpu.train.state import TrainState


def make_state(v=1.0):
    variables = {"params": {"w": jnp.full((4, 4), v)},
                 "batch_stats": {"m": jnp.zeros((4,))}}
    tx = optax.adam(1e-3)
    return TrainState.create(variables, tx, {"rot": -2.5, "trans": 0.0})


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    s1 = make_state(1.0)
    mgr.save(10, s1)
    assert mgr.latest_step() == 10
    restored = mgr.restore(make_state(0.0))
    np.testing.assert_allclose(np.asarray(restored.params["w"]), 1.0)
    np.testing.assert_allclose(float(restored.alphas["rot"]), -2.5)
    assert int(restored.step) == 0  # step lives in the state pytree

    # idempotent re-save of the same step is a no-op
    mgr.save(10, make_state(9.0))
    again = mgr.restore(make_state(0.0))
    np.testing.assert_allclose(np.asarray(again.params["w"]), 1.0)


def test_max_to_keep_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, make_state(float(step)))
    steps = sorted(mgr.all_steps())
    assert steps == [2, 3]
    r = mgr.restore(make_state(0.0), step=3)
    np.testing.assert_allclose(np.asarray(r.params["w"]), 3.0)


def test_preserve_survives_pruning(tmp_path):
    """A preserved (best) step stays restorable after max_to_keep
    prunes it from the main store (ckpt_best/ fallback)."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    mgr.save(1, make_state(1.0))
    mgr.preserve(1)
    for step in (2, 3):
        mgr.save(step, make_state(float(step)))
    assert 1 not in mgr.all_steps()
    r = mgr.restore(make_state(0.0), step=1)
    np.testing.assert_allclose(np.asarray(r.params["w"]), 1.0)
    # preserving a newer best replaces the old one
    mgr.preserve(3)
    assert not (tmp_path / "ckpt_best" / "1").exists()
    r3 = mgr.restore(make_state(0.0), step=3)
    np.testing.assert_allclose(np.asarray(r3.params["w"]), 3.0)


def test_restore_raw_and_index(tmp_path):
    """Template-free restore gives nested dicts keyed by tree path; the
    json index lists the kept steps and no temporary directory stays."""
    import json
    mgr = CheckpointManager(str(tmp_path / "run" / "ckpt"), max_to_keep=2)
    for step in (5, 6, 7):
        mgr.save(step, make_state(float(step)))
    raw = CheckpointManager.restore_raw_from(str(tmp_path / "run"))
    np.testing.assert_allclose(raw["params"]["w"], 7.0)
    np.testing.assert_allclose(raw["alphas"]["rot"], -2.5)
    assert int(raw["step"]) == 0
    index = json.loads((tmp_path / "run" / "ckpt" /
                        "checkpoints.json").read_text())
    assert index["steps"] == [6, 7]
    assert not [p for p in (tmp_path / "run" / "ckpt").iterdir()
                if p.name.startswith(".")]
    with pytest.raises(FileNotFoundError):
        CheckpointManager.restore_raw_from(str(tmp_path / "empty"))


def test_bfloat16_leaves_roundtrip(tmp_path):
    """Leaves of a dtype numpy cannot store natively come back exact."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3,
            "b": (jnp.int32(4), jnp.ones((2,), jnp.float32))}
    mgr.save(1, tree)
    back = mgr.restore(tree)
    assert back["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"], np.float32),
                                  np.asarray(tree["a"], np.float32))
    assert int(back["b"][0]) == 4


def test_best_checkpoint_nan_proof(tmp_path):
    """NaN metrics must never pin best_ckpt.json:
    average_errors deliberately returns NaN for too-short trajectories
    (eval/kitti_odometry.py:81-90) and NaN < x is always False."""
    from rslo_tpu.cli import update_best_checkpoint
    import json
    nan = float("nan")

    # all-NaN eval: nothing finite to rank on -> no record written
    assert update_best_checkpoint(tmp_path, 100, {"t_rel_pct": nan}) is None
    assert not (tmp_path / "best_ckpt.json").exists()

    # fallback key when segments are unavailable
    assert update_best_checkpoint(
        tmp_path, 200, {"t_rel_pct": nan, "frame_t_err_m": 0.9}
    ) == ("frame_t_err_m", 0.9)

    # worse fallback does not overwrite
    assert update_best_checkpoint(
        tmp_path, 300, {"frame_t_err_m": 1.5}) is None
    assert json.loads((tmp_path / "best_ckpt.json").read_text())["step"] == 200

    # the primary key becoming available wins outright, even if larger
    assert update_best_checkpoint(
        tmp_path, 400, {"t_rel_pct": 55.0, "frame_t_err_m": 1.2}
    ) == ("t_rel_pct", 55.0)

    # ordinary improvement on the primary key
    assert update_best_checkpoint(
        tmp_path, 500, {"t_rel_pct": 40.0}) == ("t_rel_pct", 40.0)
    assert update_best_checkpoint(
        tmp_path, 600, {"t_rel_pct": 47.0}) is None

    # a NaN-poisoned prior record (pre-fix writer) gets replaced
    (tmp_path / "best_ckpt.json").write_text(
        '{"step": 1, "metric": NaN, "metric_name": "t_rel_pct"}')
    assert update_best_checkpoint(
        tmp_path, 700, {"t_rel_pct": 90.0}) == ("t_rel_pct", 90.0)
    rec = json.loads((tmp_path / "best_ckpt.json").read_text())
    assert rec["step"] == 700 and rec["metric"] == 90.0


@pytest.mark.slow
def test_periodic_checkpoint_interval(tmp_path):
    """train.checkpoint_interval bounds the loss from a timeout-killed
    leg: saves must land every N steps even when steps_per_eval (and
    the leg boundary) are never reached — the round-3 queue incident
    where 900 s timeouts always fired before the first save."""
    import dataclasses
    import sys
    sys.path.insert(0, "tests")
    from test_model import tiny_cfg
    from rslo_tpu.cli import main as cli_main

    cfg = tiny_cfg()
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, seq_length=2,
                                 max_points=4096, num_workers=0),
        train=dataclasses.replace(cfg.train, steps=9, steps_per_eval=100,
                                  checkpoint_interval=4, display_step=50))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    mdir = tmp_path / "model"
    cli_main(["train", "--config", str(cfg_path), "--model_dir",
              str(mdir), "--synthetic", "--supervised", "--steps", "9"])

    mgr = CheckpointManager(str(mdir / "ckpt"), max_to_keep=8)
    steps = sorted(mgr.all_steps())
    # periodic saves at 4 and 8, final save at 9
    assert 4 in steps and 8 in steps and 9 in steps, steps
