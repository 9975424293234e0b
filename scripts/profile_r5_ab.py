"""A/B for two sparse-path levers (see profile_sparse_stages.py for the
stage split):

  1. plan build: slot_map (default) vs slot_planes (4-entry slice
     gathers, 27->9 transactions per rulebook row)
  2. convs (plans closed over): row apply vs plane apply
     (sparse_conv_apply_planes, 3x fewer gather transactions)
  3. the combined traced per-frame graph (production scenario)

Usage: python -u scripts/profile_r5_ab.py [reps]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import rslo_tpu.utils.jax_cache  # noqa: F401

import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from rslo_tpu.config.schema import PipelineCfg, grid_size
from rslo_tpu.data.prepare import prepare_example, voxelizer_config
from rslo_tpu.models.middle import build_geometry, SparseMiddleCov
from rslo_tpu.utils.synthetic import synth_sequence


def timeit_chain(name, f, x, n, perturb):
    def run(x0):
        def body(_, acc):
            out = f(perturb(x0, acc))
            return sum(jnp.sum(l.astype(jnp.float32))
                       for l in jax.tree.leaves(out))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    g = jax.jit(run)
    t0 = time.perf_counter()
    np.asarray(g(x))
    print(f"{name}: compile {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    np.asarray(g(x))
    dt = (time.perf_counter() - t0) / n
    print(f"{name}: {dt * 1e3:.2f} ms", flush=True)
    return dt


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    cfg = PipelineCfg()
    cfg = cfg.replace(middle=dataclasses.replace(
        cfg.middle, name="SparseMiddleCov", engine="rulebook"))
    vcfg = voxelizer_config(cfg)
    nx, ny, nz = grid_size(cfg.voxelizer)
    sparse_shape = (nz + 1, ny, nx)
    caps = cfg.middle.level_capacities

    frames, _ = synth_sequence(seed=0, n_frames=1,
                               n_points=cfg.data.max_points)
    pts = jnp.asarray(frames[0][None])
    msk = jnp.ones((1, pts.shape[1]), bool)
    ex = jax.jit(lambda p: prepare_example(p, msk, vcfg,
                                           mean_mode=True))(pts)
    coords, vmask = ex["coords"][0], ex["voxel_mask"][0]
    feats = ex["voxel_features"][0]

    # 1. plan build A/B
    for lk in ("slot_map", "slot_planes"):
        timeit_chain(f"B plan build [{lk}]",
                     lambda m, lk=lk: build_geometry(
                         coords, m, sparse_shape, caps, lookup=lk),
                     vmask, reps,
                     perturb=lambda m, acc: m != (acc > 1e30))

    geo = jax.jit(lambda c, m: build_geometry(c, m, sparse_shape,
                                              caps))(coords, vmask)

    # 2. conv A/B (plans closed over) — same variables both ways
    mid0 = SparseMiddleCov(cfg.middle)
    variables = mid0.init(jax.random.PRNGKey(0), feats, geo, False)
    for pa in (False, True):
        mid = SparseMiddleCov(dataclasses.replace(cfg.middle,
                                                  plane_apply=pa))
        timeit_chain(f"C convs [plane_apply={pa}]",
                     lambda f, mid=mid: mid.apply(variables, f, geo,
                                                  False),
                     feats, reps,
                     perturb=lambda f, acc: f + acc * 1e-30)

    # 3. combined production graph: slot_planes plan + plane apply
    mid = SparseMiddleCov(dataclasses.replace(cfg.middle,
                                              plane_apply=True))

    def full(m):
        g = build_geometry(coords, m, sparse_shape, caps,
                           lookup="slot_planes")
        return mid.apply(variables, feats, g, False)

    timeit_chain("D traced plan+convs [slot_planes+plane_apply]",
                 full, vmask, reps,
                 perturb=lambda m, acc: m != (acc > 1e30))


if __name__ == "__main__":
    main()
