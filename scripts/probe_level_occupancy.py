"""Occupancy probe for the sparse level capacities.

Every stage of the plan build (sorts, slot maps, 27-tap gathers, band
wraps) scales with the STATIC level capacities — and L1..L3 are capped far above their real
occupancy (a stride-2 downsample of a LiDAR shell reduces sites ~2-3x,
not 1x).  This measures actual per-level active sites for (a) the dense
synthetic bench frame and (b) proxy-store frames, to pick honest caps.

Usage: python -u scripts/probe_level_occupancy.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import rslo_tpu.utils.jax_cache  # noqa: F401

import numpy as np
import jax
import jax.numpy as jnp

from rslo_tpu.config.schema import PipelineCfg
from rslo_tpu.data.prepare import prepare_example, voxelizer_config
from rslo_tpu.models.middle import build_geometry
from rslo_tpu.utils.synthetic import synth_sequence

SHAPE = (41, 768, 1408)


def occupancy(coords, vmask, caps):
    geo = build_geometry(coords, vmask, SHAPE, caps)
    return jnp.stack([jnp.sum(l.mask.astype(jnp.int32))
                      for l in geo.levels])


def main():
    cfg = PipelineCfg()
    caps = cfg.middle.level_capacities
    vcfg = voxelizer_config(cfg)
    occ_fn = jax.jit(lambda c, m: occupancy(c, m, caps))
    prep = jax.jit(lambda p, m: prepare_example(p, m, vcfg))

    rows = []
    frames, _ = synth_sequence(seed=0, n_frames=2,
                               n_points=cfg.data.max_points)
    for i, f in enumerate(frames):
        pts = jnp.asarray(f)[None]
        mask = jnp.ones(pts.shape[:2], bool)
        ex = prep(pts, mask)
        rows.append(("bench_synth%d" % i,
                     np.asarray(occ_fn(ex["coords"][0],
                                       ex["voxel_mask"][0]))))

    h5 = Path("/tmp/rslo_proxy/proxy.h5")
    if h5.exists():
        from rslo_tpu.data.hdf5_store import SequenceReader
        cap = cfg.data.max_points
        for seq, fr in ((0, 10), (0, 200), (1, 120), (7, 50), (7, 400)):
            pts_n = SequenceReader(str(h5), seq).frame(fr)["points"]
            n = min(len(pts_n), cap)
            buf = np.zeros((cap, pts_n.shape[1]), np.float32)
            buf[:n] = pts_n[:n]
            m = np.zeros((cap,), bool)
            m[:n] = True
            ex = prep(jnp.asarray(buf)[None], jnp.asarray(m)[None])
            rows.append((f"proxy_s{seq}f{fr}",
                         np.asarray(occ_fn(ex["coords"][0],
                                           ex["voxel_mask"][0]))))

    print(f"{'frame':16s}  L0      L1      L2      L3      L4")
    for name, occ in rows:
        print(f"{name:16s}  " + "  ".join(f"{int(v):6d}" for v in occ))
    print(f"{'caps':16s}  " + "  ".join(
        f"{int(v):6d}" for v in list(caps) + [caps[-1]]))


if __name__ == "__main__":
    main()
