"""CLI-level loop-closure eval.

Renders a small looped raycast-world sequence, builds the production
HDF5 store with ``create_hdf5``, and runs ``evaluate --refine_loops``
through the CLI entry point — asserting the loop path actually fires
(``n_loops > 0``: the revisit is detected from the scans themselves)
and produces finite loop-closed metrics.  Matches the reference's
eval driver shape (/root/reference/evaluate.py:225-434); loop closing
itself is the north-star extension (BASELINE.json).
"""
import dataclasses
import json
import sys

import numpy as np
import pytest


@pytest.mark.slow
def test_cli_refine_loops(tmp_path):
    sys.path.insert(0, "tests")
    from test_model import tiny_cfg
    from rslo_tpu.cli import main
    from rslo_tpu.utils.world import write_kitti_tree

    tree = tmp_path / "tree"
    # small world + slow closed circuit sized to the tiny pc range
    write_kitti_tree(
        tree, {0: (36, "loop", 3.0)}, world_seed=3,
        n_beams=16, n_azimuth=512,
        world_kwargs=dict(extent=10.0, n_walls=30, n_boxes=12,
                          n_cyl=14, corridor=2.5))
    h5 = tmp_path / "store.h5"
    main(["create_hdf5", "--kitti_root", str(tree), "--out", str(h5),
          "--sequences", "0"])

    cfg = tiny_cfg()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, root=str(h5), val_sequences=(0,), num_workers=0,
        max_points=8192))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    mdir = tmp_path / "model"
    main(["evaluate", "--config", str(cfg_path), "--model_dir",
          str(mdir), "--refine_loops", "--loop_min_separation", "10",
          "--max_windows", "16"])

    res = json.loads((mdir / "eval_results.json").read_text())
    seqs = [k for k in res if k.startswith("seq_")]
    assert seqs
    for k in seqs:
        assert res[k]["n_loops"] > 0, res[k]
        assert np.isfinite(res[k]["loop_closed"]["t_rel_pct"])
        assert np.isfinite(res[k]["chained"]["t_rel_pct"])
