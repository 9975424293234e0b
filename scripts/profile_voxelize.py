"""Voxelizer stage breakdown.

The sorted-mean voxelizer is latency-bound (~0.1 GFLOP at 131k
points): this splits it into its primitive stages to decide whether a
radix/bucket kernel could beat the XLA sort, and measures the lean
formulation (fused (vid,iota) sort, unsorted scatter-add,
ones-column counts) against its stages.

Stages (each chained device-side, ONE host fetch per timing):
  ids      grid binning + linear id (elementwise)
  sort     lax.sort((vid, iota))
  seg      head/slot/rank bookkeeping (cumsum/cummax on N)
  route    .at[order].set int32 scatter (slot back to original rows)
  scatter  (N, F+1) scatter-add of unsorted rows
  full     voxelize_sorted_mean end to end

Usage: python -u scripts/profile_voxelize.py [reps]
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
from rslo_tpu.data.prepare import voxelizer_config
from rslo_tpu.ops.voxelize import voxelize_sorted_mean
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
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    cfg = PipelineCfg()
    vcfg = voxelizer_config(cfg)
    nx, ny, nz = (int(g) for g in vcfg.grid_size)
    sentinel = nx * ny * nz
    V, P = vcfg.max_voxels, vcfg.max_points
    F = 7

    frames, _ = synth_sequence(seed=0, n_frames=1,
                               n_points=cfg.data.max_points)
    pts = jnp.asarray(frames[0])
    N = pts.shape[0]
    msk = jnp.ones((N,), bool)
    print(f"N={N} V={V} grid=({nx},{ny},{nz})", flush=True)

    pr = jnp.asarray(vcfg.point_cloud_range, pts.dtype)
    vs = jnp.asarray(vcfg.voxel_size, pts.dtype)

    def ids(p):
        cxyz = jnp.floor((p[:, :3] - pr[:3]) / vs).astype(jnp.int32)
        valid = jnp.all((cxyz >= 0) & (cxyz < jnp.array([nx, ny, nz])),
                        axis=-1)
        vid = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
        return jnp.where(valid, vid, sentinel)

    timeit_chain("ids (binning)", ids, pts, reps,
                 lambda p, acc: p + acc * 1e-30)

    vid0 = jax.jit(ids)(pts)
    iota = jnp.arange(N, dtype=jnp.int32)

    def srt(v):
        return jax.lax.sort((v, iota), is_stable=True, num_keys=1)

    timeit_chain("sort (vid, iota)", srt, vid0, reps,
                 lambda v, acc: jnp.minimum(v + (acc > 1e30), sentinel))

    svid0, order0 = jax.jit(srt)(vid0)

    def seg(svid):
        head = jnp.concatenate([jnp.array([True]),
                                svid[1:] != svid[:-1]]) & (svid < sentinel)
        voxel_slot = jnp.cumsum(head.astype(jnp.int32)) - 1
        seg_start = jax.lax.cummax(jnp.where(head, iota, -1))
        rank = iota - seg_start
        keep_s = (svid < sentinel) & (voxel_slot < V) & (rank < P)
        return jnp.where(keep_s, voxel_slot, V)

    timeit_chain("seg (head/slot/rank)", seg, svid0, reps,
                 lambda v, acc: jnp.minimum(v + (acc > 1e30), sentinel))

    slot0 = jax.jit(seg)(svid0)

    def route(s):
        return jnp.zeros((N,), jnp.int32).at[order0].set(s)

    timeit_chain("route (.at[order].set)", route, slot0, reps,
                 lambda s, acc: jnp.minimum(s + (acc > 1e30), V))

    pslot0 = jax.jit(route)(slot0)

    def scat(p):
        keep = pslot0 < V
        fe = jnp.concatenate([p, jnp.ones((N, 1), p.dtype)], 1)
        return jnp.zeros((V + 1, F + 1), p.dtype).at[pslot0].add(
            jnp.where(keep[:, None], fe, 0.0))[:V]

    timeit_chain("scatter-add (N, F+1)", scat, pts, reps,
                 lambda p, acc: p + acc * 1e-30)

    timeit_chain("FULL voxelize_sorted_mean",
                 lambda p: voxelize_sorted_mean(p, msk, vcfg), pts, reps,
                 perturb=lambda p, acc: p + acc * 1e-30)


if __name__ == "__main__":
    main()
