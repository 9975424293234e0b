"""Probe: slot-map gather formulations for the rulebook build.

The L0 submanifold rulebook costs 1.1M random int32 gathers into a
44M-entry (177 MB) table.  Candidates to cut memory transactions:

  a. baseline: (V*27,) singleton gathers, int32 table
  b. uint16 table (88 MB): same gathers, half the line traffic
  c. segment gathers: the 3 x-taps of each (dz,dy) plane are adjacent
     in the table, so gather (V*9, 4)-entry slices instead (3x fewer
     transactions, contiguous 16 B reads) — int32 and uint16 variants

Honest chained single-fetch timing.  If (c) wins, the 'slot_planes'
rulebook builder is worth building; if not, slot_map stays as is.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import rslo_tpu.utils.jax_cache  # noqa: F401

import numpy as np
import jax
import jax.numpy as jnp

T = 41 * 768 * 1408          # L0 dense id space
V = 40960
K = 27
P = 9


def timeit(name, f, args, n=20):
    def run(a):
        def body(i, acc):
            out = f(*a, knob=i)
            return acc + jnp.sum(out.astype(jnp.float32))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))
    g = jax.jit(run)
    np.asarray(g(args))
    t0 = time.perf_counter()
    np.asarray(g(args))
    dt = (time.perf_counter() - t0) / n
    print(f"{name:46s} {dt * 1e3:8.2f} ms", flush=True)


def main():
    rng = np.random.default_rng(0)
    # realistic queries: clustered like sorted voxel neighborhoods
    base = np.sort(rng.choice(T - 2000, size=V, replace=False))
    offs = rng.integers(-700, 700, size=(V, K))
    q27 = jnp.asarray((base[:, None] + offs).clip(0, T - 4))
    q9 = jnp.asarray((base[:, None] + offs[:, :P]).clip(0, T - 4))
    tbl32 = jnp.asarray(rng.integers(0, V, size=(T,), dtype=np.int32))
    tbl16 = tbl32.astype(jnp.uint16)

    def singles(tbl, q, knob):
        return tbl[(q + knob) % (T - 4)]

    def segs(tbl, q, knob):
        st = ((q + knob) % (T - 4)).reshape(-1, 1)
        import jax.lax as lax
        dn = lax.GatherDimensionNumbers(offset_dims=(1,),
                                        collapsed_slice_dims=(),
                                        start_index_map=(0,))
        out = lax.gather(tbl, st, dn, slice_sizes=(4,),
                         mode=lax.GatherScatterMode.CLIP)
        return out

    timeit("singleton gathers x27 [int32 177MB]", singles, (tbl32, q27))
    timeit("singleton gathers x27 [uint16 88MB]", singles, (tbl16, q27))
    timeit("4-entry slice gathers x9 [int32]", segs, (tbl32, q9))
    timeit("4-entry slice gathers x9 [uint16]", segs, (tbl16, q9))
    timeit("singleton gathers x9 (lower bound)", singles, (tbl32, q9))


if __name__ == "__main__":
    main()
