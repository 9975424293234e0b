"""A/B of the rulebook lookup methods (KITTI scale, 1 frame):

  slot_map — dense id->slot table, one random gather per (row, tap)
  ranked   — windowed compare-reduce ranks (sparse_conv._lookup_ranked)

Times FULL build_geometry and FULL build_band_geometry under both, plus
the L0 submanifold rulebook alone (the slot-map path's largest
table).  Chained single-fetch harness.  Also fetches the stray diagnostics once: at deployed shapes
the ranked path must resolve every query in-window or via the 8192-cap
fallback (exactness guard).

Usage: python -u scripts/profile_plan_lookup.py [reps]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import rslo_tpu.utils.jax_cache  # noqa: F401

import numpy as np
import jax
import jax.numpy as jnp

from rslo_tpu.config.schema import PipelineCfg
from rslo_tpu.data.prepare import prepare_example, voxelizer_config
from rslo_tpu.models.middle import build_band_geometry, build_geometry
from rslo_tpu.ops import sparse_conv as sc
from rslo_tpu.utils.synthetic import synth_sequence

SHAPE = (41, 768, 1408)


def timeit_chain(name, f, args, n):
    def run(a):
        def body(i, acc):
            out = f(*a, knob=i)
            s = sum(jnp.sum(l.astype(jnp.float32)) for l in
                    jax.tree.leaves(out) if hasattr(l, "astype"))
            return acc + s
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    g = jax.jit(run)
    t0 = time.perf_counter()
    np.asarray(g(args))
    c = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(g(args))
    dt = (time.perf_counter() - t0) / n
    print(f"{name:44s} {dt * 1e3:8.2f} ms   (compile {c:.1f}s)",
          flush=True)
    return dt


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    cfg = PipelineCfg()
    caps = cfg.middle.level_capacities
    ch = cfg.middle.channels
    vcfg = voxelizer_config(cfg)
    frames, _ = synth_sequence(seed=0, n_frames=1,
                               n_points=cfg.data.max_points)
    pts = jnp.asarray(np.stack(frames))
    mask = jnp.ones(pts.shape[:2], bool)
    ex = jax.jit(lambda p, m: prepare_example(p, m, vcfg))(pts, mask)
    coords, vmask = ex["coords"][0], ex["voxel_mask"][0]

    def vary(m, knob):
        return m.at[knob % m.shape[0]].set(False)

    for lk in ("slot_map", "slot_planes", "ranked", "ranked_planes", "sorted_planes"):
        timeit_chain(f"FULL build_geometry [{lk}]",
                     lambda c, m, knob, lk=lk: build_geometry(
                         c, vary(m, knob), SHAPE, caps, lookup=lk),
                     (coords, vmask), reps)
        timeit_chain(f"FULL build_band_geometry [{lk}]",
                     lambda c, m, knob, lk=lk: build_band_geometry(
                         c, vary(m, knob), SHAPE, caps, channels=ch,
                         min_channels=0, lookup=lk),
                     (coords, vmask), reps)

    l0 = jax.jit(lambda c, m: sc.with_slot_map(
        sc.level_from_coords(c, m, SHAPE)))(coords, vmask)

    def vary_l(l, knob):
        return l.replace(mask=l.mask.at[knob % l.capacity].set(False))

    timeit_chain("subm rulebook L0 [slot_map]",
                 lambda l, knob: sc.build_submanifold_index(
                     vary_l(l, knob)),
                 (l0,), reps)
    timeit_chain("subm rulebook L0 [ranked]",
                 lambda l, knob: sc.build_submanifold_index(
                     vary_l(l, knob).replace(slot_map=None),
                     lookup="ranked"),
                 (l0,), reps)
    for rm in ("ranked", "sorted"):
        timeit_chain(f"subm rulebook L0 [{rm}_planes]",
                     lambda l, knob, rm=rm:
                     sc.build_submanifold_index_planes(
                         vary_l(l, knob).replace(slot_map=None),
                         rank_method=rm),
                     (l0,), reps)
    timeit_chain("subm rulebook L0 [slot_planes]",
                 lambda l, knob: sc.build_submanifold_index_slot_planes(
                     vary_l(l, knob)),
                 (l0,), reps)

    # exactness on the real frame: every method == slot_map, bit for bit
    ga = jax.jit(lambda c, m: build_geometry(c, m, SHAPE, caps))(
        coords, vmask)
    worst = 0
    for lk in ("slot_planes", "ranked", "ranked_planes", "sorted_planes"):
        gb = jax.jit(lambda c, m, lk=lk: build_geometry(
            c, m, SHAPE, caps, lookup=lk))(coords, vmask)
        for name in ("sub_rb", "down_rb", "inv_rb"):
            for i, (a, b) in enumerate(zip(getattr(ga, name),
                                           getattr(gb, name))):
                va, vb = np.asarray(a.valid), np.asarray(b.valid)
                dv = int((va != vb).sum())
                di = int((np.asarray(a.idx)[va & vb]
                          != np.asarray(b.idx)[va & vb]).sum())
                worst = max(worst, dv, di)
                if dv or di:
                    print(f"parity[{lk}] {name}[{i}]: valid mismatches "
                          f"{dv}, idx mismatches {di}", flush=True)
    print("PARITY", "OK" if worst == 0 else f"FAIL ({worst})",
          flush=True)


if __name__ == "__main__":
    main()
