"""Stage-wise profiler for the sparse geometry build (indice_key analog).

When the band-stage profile (profile_band_stages.py) shows the plan
build dominating the convs, this splits it into
primitive stages with the chained single-fetch harness (each stage runs
``reps`` times device-side inside one jit; one host fetch total) to
decide which primitive to attack: the dedup sorts, the dense slot-map
scatters, the 27-tap lookups, or the band-plan overflow bookkeeping.

Usage: python -u scripts/profile_geometry.py [reps]
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
from rslo_tpu.models.middle import (DOWN_SPECS, build_band_geometry,
                                    build_geometry)
from rslo_tpu.ops import band_conv as bc
from rslo_tpu.ops import sparse_conv as sc
from rslo_tpu.utils.synthetic import synth_sequence

SHAPE = (41, 768, 1408)


def timeit_chain(name, f, args, n):
    """Chain n evaluations device-side (perturbing an int knob through
    the iteration counter so XLA cannot CSE the body), fetch ONE
    reduction."""

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
    print(f"{name:40s} {dt * 1e3:8.2f} ms   (compile {c:.1f}s)",
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
    print(f"caps={caps} channels={ch} "
          f"band_min_channels={cfg.middle.band_min_channels}", flush=True)

    # knob: flip one coord's mask bit per iteration — cheap, defeats CSE
    def vary(m, knob):
        return m.at[knob % m.shape[0]].set(False)

    timeit_chain("FULL build_geometry", lambda c, m, knob:
                 build_geometry(c, vary(m, knob), SHAPE, caps),
                 (coords, vmask), reps)
    timeit_chain("FULL build_band_geometry (deployed)", lambda c, m, knob:
                 build_band_geometry(
                     c, vary(m, knob), SHAPE, caps, channels=ch,
                     min_channels=cfg.middle.band_min_channels),
                 (coords, vmask), reps)
    timeit_chain("FULL build_band_geometry (wrap all)", lambda c, m, knob:
                 build_band_geometry(c, vary(m, knob), SHAPE, caps),
                 (coords, vmask), reps)

    timeit_chain("level_from_coords L0 (argsort 40960)",
                 lambda c, m, knob: sc.level_from_coords(
                     c, vary(m, knob), SHAPE), (coords, vmask), reps)
    timeit_chain("with_slot_map L0 (44M dense scatter)",
                 lambda c, m, knob: sc.with_slot_map(
                     sc.level_from_coords(c, vary(m, knob), SHAPE)).slot_map,
                 (coords, vmask), reps)

    mk_l0 = jax.jit(lambda c, m: sc.with_slot_map(
        sc.level_from_coords(c, m, SHAPE)))
    l0 = jax.tree.map(lambda x: x, mk_l0(coords, vmask))

    def vary_l(l, knob):
        return l.replace(mask=l.mask.at[knob % l.capacity].set(False))

    timeit_chain("downsample L0->L1 (sort dedup)",
                 lambda l, knob: sc.downsample_level(
                     vary_l(l, knob), *DOWN_SPECS[0], out_capacity=caps[1]),
                 (l0,), reps)
    timeit_chain("downsample L0->L1 (scatter dedup)",
                 lambda l, knob: sc.downsample_level_scatter(
                     vary_l(l, knob), *DOWN_SPECS[0], out_capacity=caps[1]),
                 (l0,), reps)

    l1 = jax.jit(lambda l: sc.with_slot_map(sc.downsample_level(
        l, *DOWN_SPECS[0], out_capacity=caps[1])))(l0)
    timeit_chain("downsample L1->L2 (sort dedup)",
                 lambda l, knob: sc.downsample_level(
                     vary_l(l, knob), *DOWN_SPECS[1], out_capacity=caps[2]),
                 (l1,), reps)
    timeit_chain("downsample L1->L2 (scatter dedup)",
                 lambda l, knob: sc.downsample_level_scatter(
                     vary_l(l, knob), *DOWN_SPECS[1], out_capacity=caps[2]),
                 (l1,), reps)
    timeit_chain("slot_map L1", lambda l, knob:
                 sc.with_slot_map(vary_l(l, knob)).slot_map, (l1,), reps)

    timeit_chain("subm rulebook L0 (27-tap slotmap gather)",
                 lambda l, knob: sc.build_submanifold_index(vary_l(l, knob)),
                 (l0,), reps)
    timeit_chain("subm rulebook L1",
                 lambda l, knob: sc.build_submanifold_index(vary_l(l, knob)),
                 (l1,), reps)
    timeit_chain("conv index L0->L1",
                 lambda a, b, knob: sc.build_conv_index(
                     vary_l(a, knob), b, *DOWN_SPECS[0]), (l0, l1), reps)
    timeit_chain("inverse index L1->L0",
                 lambda a, b, knob: sc.build_inverse_index(
                     vary_l(a, knob), b, *DOWN_SPECS[0]), (l1, l0), reps)

    rb0 = jax.jit(sc.build_submanifold_index)(l0)

    def vary_rb(rb, knob):
        return sc.ConvIndex(rb.idx,
                            rb.valid.at[knob % rb.valid.shape[0], 0].set(
                                False))

    timeit_chain("band wrap subm L0 (40960x27 plan)",
                 lambda r, knob: bc.build_band_index(
                     vary_rb(r, knob), l0.capacity, window=bc.SUBM_WINDOW,
                     self_transpose=True), (rb0,), reps)
    rb1 = jax.jit(sc.build_submanifold_index)(l1)
    timeit_chain("band wrap subm L1 (40960x27 plan)",
                 lambda r, knob: bc.build_band_index(
                     vary_rb(r, knob), l1.capacity, window=bc.SUBM_WINDOW,
                     self_transpose=True), (rb1,), reps)


if __name__ == "__main__":
    main()
