"""Eval runner integration (plain + refined) on tiny shapes, 8-dev mesh."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from rslo_tpu.config.schema import DataCfg
from rslo_tpu.eval.runner import run_eval, run_eval_refined
from rslo_tpu.train.step import make_eval_step


@pytest.fixture(scope="module")
def setup():
    import sys
    sys.path.insert(0, "tests")
    from test_model import tiny_cfg
    from rslo_tpu.cli import _synthetic_dataset
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.data.loader import collate
    from rslo_tpu.data.prepare import prepare_example, voxelizer_config

    cfg = tiny_cfg()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, seq_length=3, max_points=4096))
    net = OdomNet(cfg)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    ds3 = _synthetic_dataset(cfg, "train", n_windows=12)
    vcfg = voxelizer_config(cfg)
    b0 = collate([ds3[0]], cfg.data)
    ex0 = prepare_example(jnp.asarray(b0["points"][0]),
                          jnp.asarray(b0["point_mask"][0]), vcfg)
    variables = net.init(jax.random.PRNGKey(0), ex0, train=False)
    eval_step = make_eval_step(net, cfg, mesh)
    return cfg, net, mesh, variables, eval_step, ds3


def test_run_eval_refined(setup, tmp_path):
    cfg, net, mesh, variables, eval_step, ds3 = setup
    res = run_eval_refined(net, variables, ds3, cfg, mesh, eval_step,
                           max_windows=12, window=8, overlap=2, iters=3)
    assert res["_meta"]["windows"] == 12
    seqs = [k for k in res if k.startswith("seq_")]
    assert seqs
    for k in seqs:
        assert np.isfinite(res[k]["refined"]["t_rel_pct"])
        assert np.isfinite(res[k]["chained"]["t_rel_pct"])


def test_run_eval_plain(setup, tmp_path):
    cfg, net, mesh, variables, eval_step, ds3 = setup
    import dataclasses as dc
    from rslo_tpu.cli import _synthetic_dataset
    cfg2 = cfg.replace(data=dc.replace(cfg.data, seq_length=2))
    ds2 = _synthetic_dataset(cfg2, "val", n_windows=10)
    res = run_eval(net, variables, ds2, cfg2, mesh, eval_step,
                   max_windows=10, plot_dir=str(tmp_path))
    assert "avg" in res
    assert (tmp_path / "traj_00.png").exists()

def test_run_eval_refined_with_ba(setup):
    cfg, net, mesh, variables, eval_step, ds3 = setup
    res = run_eval_refined(net, variables, ds3, cfg, mesh, eval_step,
                           max_windows=8, window=8, overlap=2, iters=3,
                           use_ba=True, ba_points=512)
    seqs = [k for k in res if k.startswith("seq_")]
    assert seqs
    for k in seqs:
        assert np.isfinite(res[k]["refined"]["t_rel_pct"])


def test_run_eval_refined_with_cov_ba(setup):
    """Covariance-weighted BA path: the eval step
    returns the network's voxel points + cov params and run_eval_refined
    whitens the BA observations with the full 3x3 information blocks."""
    cfg, net, mesh, variables, eval_step, ds3 = setup
    eval_step_cov = make_eval_step(net, cfg, mesh, with_cov=True)
    res = run_eval_refined(net, variables, ds3, cfg, mesh, eval_step,
                           max_windows=8, window=8, overlap=2, iters=3,
                           use_ba=True, ba_points=512,
                           eval_step_cov=eval_step_cov)
    seqs = [k for k in res if k.startswith("seq_")]
    assert seqs
    for k in seqs:
        assert np.isfinite(res[k]["refined"]["t_rel_pct"])


def test_run_eval_refined_with_loops(setup):
    """use_loops plumbing: descriptors + detection run over the fused
    trajectory (the short synthetic track has no revisits, so 0 loops
    is the expected count and the loop-closed trajectory still fuses
    from the chain graph)."""
    cfg, net, mesh, variables, eval_step, ds3 = setup
    res = run_eval_refined(net, variables, ds3, cfg, mesh, eval_step,
                           max_windows=8, window=8, overlap=2, iters=3,
                           use_loops=True, loop_min_separation=4,
                           loop_points=512)
    seqs = [k for k in res if k.startswith("seq_")]
    assert seqs
    for k in seqs:
        assert "n_loops" in res[k]
        if res[k]["n_loops"] >= 0:
            assert np.isfinite(res[k]["loop_closed"]["t_rel_pct"])
