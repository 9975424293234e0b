"""Stage breakdown of the band-engine sparse path: is the two-frame
forward dominated by the per-frame PLAN BUILD (sorted-level geometry +
band index construction) or by the conv compute?

  - plan build dominates -> incremental/reused plans across frames (the
    voxel set changes slowly frame to frame in odometry streaming);
  - conv compute dominates -> a fused gather-GEMM conv.

Times four jitted graphs with a single-fetch methodology (device-side
fori_loop chain, ONE host fetch for the whole rep train):
  A. voxelize (sorted-mean) per frame
  B. build_band_geometry per frame  (plans for all levels)
  C. all band convs, plans CLOSED OVER (jit constants — the cached-plan
     scenario; XLA may pre-fold plan-dependent transforms)
  D. all band convs, plans TRACED (the per-frame production scenario)

Usage: python -u scripts/profile_band_stages.py [reps]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import rslo_tpu.utils.jax_cache  # noqa: F401

import numpy as np
import jax
import jax.numpy as jnp

from rslo_tpu.config.schema import PipelineCfg, grid_size
from rslo_tpu.data.prepare import prepare_example, voxelizer_config
from rslo_tpu.models.middle import build_band_geometry
from rslo_tpu.utils.synthetic import synth_sequence


def timeit_chain(name, f, x, n, perturb):
    """Time f by running it n times inside one jitted fori_loop with a
    loop-carried data dependence (via `perturb(x, acc)`) so XLA cannot
    CSE or hoist the body, then ONE host fetch of the scalar carry.
    """
    def run(x0):
        def body(_, acc):
            out = f(perturb(x0, acc))
            # reduce EVERY output leaf: consuming a single element lets
            # XLA dead-code-eliminate most of the body (first run of
            # this script measured a 6x-too-fast conv stage that way)
            return sum(jnp.sum(l.astype(jnp.float32))
                       for l in jax.tree.leaves(out))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    g = jax.jit(run)
    t0 = time.perf_counter()
    np.asarray(g(x))  # compile + warm
    print(f"{name}: compile {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    np.asarray(g(x))
    dt = (time.perf_counter() - t0) / n
    print(f"{name}: {dt * 1e3:.2f} ms", flush=True)
    return dt


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    import dataclasses
    cfg = PipelineCfg()
    cfg = cfg.replace(middle=dataclasses.replace(
        cfg.middle, name="SparseMiddleCov", engine="band"))
    vcfg = voxelizer_config(cfg)
    # The model linearizes ids over (nz+1, ny, nx) — net.py::sparse_shape
    # (z-pad +1, zyx order), NOT vcfg.grid_size which is (nx, ny, nz).
    nx, ny, nz = grid_size(cfg.voxelizer)
    sparse_shape = (nz + 1, ny, nx)
    caps = cfg.middle.level_capacities
    print(f"sparse_shape={sparse_shape} caps={caps}", flush=True)

    frames, _ = synth_sequence(seed=0, n_frames=1,
                               n_points=cfg.data.max_points)
    pts = jnp.asarray(frames[0][None])
    msk = jnp.ones((1, pts.shape[1]), bool)

    vox_fn = lambda p: prepare_example(p, msk, vcfg, mean_mode=True)
    timeit_chain("A voxelize+meanVFE (1 frame)", vox_fn, pts, reps,
                 perturb=lambda p, acc: p + acc * 1e-30)

    ex = jax.jit(vox_fn)(pts)
    coords, vmask = ex["coords"][0], ex["voxel_mask"][0]
    feats = ex["voxel_features"][0]

    geo_fn = lambda c, m: build_band_geometry(c, m, sparse_shape, caps)
    # int coords can't carry a float perturbation; thread the dependence
    # through the mask instead (m != (acc > 1e30) == m at runtime).
    timeit_chain("B band plan build (1 frame, all levels)",
                 lambda m: geo_fn(coords, m), vmask, reps,
                 perturb=lambda m, acc: m != (acc > 1e30))

    from rslo_tpu.models.middle import SparseMiddleCov
    geo = jax.jit(geo_fn)(coords, vmask)
    mid = SparseMiddleCov(cfg.middle)
    variables = mid.init(jax.random.PRNGKey(0), feats, geo, False)

    # C: plans closed over (jit constants — cached-plan best case).
    timeit_chain("C band convs, plans as jit consts (1 frame)",
                 lambda f: mid.apply(variables, f, geo, False),
                 feats, reps,
                 perturb=lambda f, acc: f + acc * 1e-30)

    # D: plan build + convs in ONE graph with the plans traced — the
    # production per-frame scenario (the net builds geometry then runs
    # the middle inside one jit).  Report D and the D-B conv residual.
    def build_and_conv(m):
        g = geo_fn(coords, m)
        return mid.apply(variables, feats, g, False)

    dt_b = timeit_chain("B' (re-run for residual)",
                        lambda m: geo_fn(coords, m), vmask, reps,
                        perturb=lambda m, acc: m != (acc > 1e30))
    dt_d = timeit_chain("D plan build + convs, plans traced (1 frame)",
                        build_and_conv, vmask, reps,
                        perturb=lambda m, acc: m != (acc > 1e30))
    print(f"D-B traced-conv residual: {(dt_d - dt_b) * 1e3:.2f} ms",
          flush=True)


if __name__ == "__main__":
    main()
