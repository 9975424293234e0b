"""Tiled dense engine for sparse 3D convolution.

The rulebook engine (:mod:`rslo_tpu.ops.sparse_conv`) is architecture-
exact but bound by per-layer row gathers ((V, 27) rows of 64 B) and
per-frame rulebook builds (sorts + lookups).  This engine re-designs the
same math around contiguous dense blocks:

  * Each high-resolution level is a fixed-capacity set of dense tiles
    (default 2x8x8 — LiDAR occupancy is a thin, scattered shell, so
    short-z tiles triple the fill factor vs 8^3) plus one always-zero
    pad row.  Features live as ``(T+1, tz, ty, tx, C)`` blocks; all
    data movement is whole-tile / face-slab gathers (KB-sized rows at
    near-peak HBM bandwidth) instead of 64-byte scatter-gather.
  * Convolutions are batched dense ``lax.conv`` over halo-extended
    blocks — an implicit im2col GEMM.  Submanifold semantics
    (outputs only at active sites, reference SubMConv3d,
    /root/reference/rslo/models/middle.py:119-244) come from masking
    with per-tile occupancy after every layer.
  * Halos are assembled with the classic 3-pass axis exchange: after
    the z faces are attached, gathering a y face from an already
    z-haloed neighbor carries the zy corner tiles automatically, etc.
  * A cell of a strided (downsample) conv's output grid is **owned** by
    exactly one input tile (``owner = floor(cell / half_tile)``), and
    tile activity is dilated one tile towards lower indices ("ghost
    tiles") so the owner of every reachable output cell exists.  The
    owned half-tile output blocks scatter into the coarse level without
    overlap through 8 parity classes with static octant slices.
  * Deep levels (1/4, 1/8 res) are small enough to keep fully dense.
  * Tile discovery is sort-free: occupancy scatter over the (small)
    dense tile grid + cumsum compaction.  Nothing in the engine sorts
    or binary-searches.

Coordinates are (z, y, x) like the rest of the stack; a level's grid is
padded up to a tile multiple (padded cells are never active).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

DEFAULT_TILE = (2, 8, 8)


def _cdiv(a, b):
    return -(-a // b)


@pytree.dataclass
class TileLevel:
    """Active-tile structure of one tiled level.

    tile_coords: (T, 3) int32 tile-grid coords (invalid rows 0).
    tile_mask:   (T,) bool.
    slot_map:    (TG + 1,) int32 tile-grid id -> slot + 1 (0 = none).
    nb_lo/nb_hi: (T + 1, 3) int32 neighbor slot per axis; absent / pad
                 row -> T (the zero pad row).
    occ:         (T + 1, tz, ty, tx) bool cell activity (pad row False).
    grid:        static true (nz, ny, nx) of the level.
    tgrid:       static tile-grid dims.
    tile:        static tile shape (tz, ty, tx), even dims.
    """
    tile_coords: jax.Array
    tile_mask: jax.Array
    slot_map: jax.Array
    nb_lo: jax.Array
    nb_hi: jax.Array
    occ: jax.Array
    grid: tuple = pytree.static_field()
    tgrid: tuple = pytree.static_field()
    tile: tuple = pytree.static_field()

    @property
    def capacity(self) -> int:
        return self.tile_coords.shape[0]

    @property
    def cells(self) -> int:
        return int(np.prod(self.tile))

    @property
    def half(self) -> tuple:
        return tuple(t // 2 for t in self.tile)


@pytree.dataclass
class TiledGeometry:
    """Per-frame geometry for the tiled engine (indice_key analog)."""
    l0: TileLevel
    l1: TileLevel
    cell_index: jax.Array        # (V,) voxel row -> flat cell (dump = last)
    occ2: jax.Array              # (z2, y2, x2) bool  (dense levels)
    occ3: jax.Array              # (z3, y3, x3) bool
    occ4: jax.Array              # (z4, y4, x4) bool


def _linearize(c, tgrid):
    return (c[..., 0] * tgrid[1] + c[..., 1]) * tgrid[2] + c[..., 2]


def _compact_tiles(act_flat: jax.Array, tgrid, capacity: int):
    """Dense activity flags -> (tile_coords, tile_mask, slot_map).

    Sort-free: rank via cumsum, scatter tile ids into their rank slot."""
    TG = int(np.prod(tgrid))
    rank = jnp.cumsum(act_flat.astype(jnp.int32)) - 1
    slot = jnp.where(act_flat & (rank < capacity), rank, capacity)
    ids = jnp.full((capacity + 1,), TG, jnp.int32)
    ids = ids.at[slot].set(
        jnp.where(slot < capacity,
                  jnp.arange(TG, dtype=jnp.int32), TG))[:capacity]
    mask = ids < TG
    zz = ids // (tgrid[1] * tgrid[2])
    yy = (ids // tgrid[2]) % tgrid[1]
    xx = ids % tgrid[2]
    coords = jnp.where(mask[:, None], jnp.stack([zz, yy, xx], -1), 0)
    slot_map = jnp.zeros((TG + 1,), jnp.int32).at[
        jnp.where(mask, ids, TG)].set(
        jnp.arange(capacity, dtype=jnp.int32) + 1)
    slot_map = slot_map.at[TG].set(0)
    return coords.astype(jnp.int32), mask, slot_map


def _neighbors(coords, mask, slot_map, tgrid, capacity):
    """Per-axis lo/hi neighbor slots, (T + 1, 3); absent -> pad row T."""
    nb = {}
    for name, sgn in (("lo", -1), ("hi", 1)):
        cols = []
        for ax in range(3):
            q = coords.at[:, ax].add(sgn)
            inb = (q[:, ax] >= 0) & (q[:, ax] < tgrid[ax]) & mask
            qid = jnp.where(inb, _linearize(q, tgrid),
                            int(np.prod(tgrid)))
            s = slot_map[qid] - 1
            cols.append(jnp.where(s >= 0, s, capacity))
        col = jnp.stack(cols, -1).astype(jnp.int32)
        nb[name] = jnp.concatenate(
            [col, jnp.full((1, 3), capacity, jnp.int32)], axis=0)
    return nb["lo"], nb["hi"]


def _ghost_dilate(act3d: jax.Array) -> jax.Array:
    """Activate a tile when it or any -1-offset (towards LOWER indices)
    neighbor is occupied: the owner of output cell c of a strided conv
    is floor(c/half) in tile coords, fed by input tiles owner and
    owner-1 — so owner must exist whenever owner-1 is occupied."""
    out = act3d
    for ax in range(3):
        pad = [(0, 0)] * 3
        pad[ax] = (1, 0)
        shifted = jnp.pad(out, pad)[
            tuple(slice(0, act3d.shape[i]) for i in range(3))]
        out = out | shifted
    return out


def _build_level(occ_flag, tgrid, grid, tile, capacity: int):
    act = _ghost_dilate(occ_flag.reshape(tgrid)).reshape(-1)
    coords, mask, slot_map = _compact_tiles(act, tgrid, capacity)
    nb_lo, nb_hi = _neighbors(coords, mask, slot_map, tgrid, capacity)
    return coords, mask, slot_map, nb_lo, nb_hi


def build_l0(coords: jax.Array, vmask: jax.Array, sparse_shape,
             capacity: int, tile=DEFAULT_TILE):
    """Voxel coords (V, 3) zyx -> L0 TileLevel + per-voxel cell index."""
    tz, ty, tx = tile
    cells = tz * ty * tx
    tgrid = tuple(_cdiv(sparse_shape[d], tile[d]) for d in range(3))
    TG = int(np.prod(tgrid))
    tcoord = coords // jnp.asarray(tile, jnp.int32)
    tid = jnp.where(vmask, _linearize(tcoord, tgrid), TG)
    occ_flag = jnp.zeros((TG + 1,), bool).at[tid].set(True)[:TG]
    c, m, sm, nlo, nhi = _build_level(occ_flag, tgrid, sparse_shape,
                                      tile, capacity)
    # per-voxel flat cell index (dump cell = last)
    slot = sm[jnp.minimum(tid, TG)] - 1
    lc = coords - tcoord * jnp.asarray(tile, jnp.int32)
    lcell = (lc[:, 0] * ty + lc[:, 1]) * tx + lc[:, 2]
    ok = vmask & (slot >= 0)
    dump = (capacity + 1) * cells
    cell_index = jnp.where(ok, slot * cells + lcell, dump).astype(
        jnp.int32)
    occ = jnp.zeros(((capacity + 1) * cells + 1,), bool).at[
        cell_index].set(ok)[:-1].reshape((capacity + 1,) + tile)
    lvl = TileLevel(c, m, sm, nlo, nhi, occ, tuple(sparse_shape), tgrid,
                    tuple(tile))
    return lvl, cell_index


def scatter_voxels(features: jax.Array, cell_index: jax.Array,
                   lvl: TileLevel) -> jax.Array:
    """(V, C) rows -> (T + 1, tz, ty, tx, C) blocks (pad row zero)."""
    C = features.shape[-1]
    flat = jnp.zeros(((lvl.capacity + 1) * lvl.cells + 1, C),
                     features.dtype)
    flat = flat.at[cell_index].set(features)
    return flat[:-1].reshape((lvl.capacity + 1,) + lvl.tile + (C,))


def gather_voxels(blocks: jax.Array, cell_index: jax.Array) -> jax.Array:
    """(T + 1, tz, ty, tx, C) blocks -> (V, C) rows (dump reads 0)."""
    C = blocks.shape[-1]
    flat = blocks.reshape(-1, C)
    flat = jnp.concatenate([flat, jnp.zeros((1, C), blocks.dtype)], 0)
    return flat[cell_index]


def _halo_axis(x: jax.Array, nb_lo_ax, nb_hi_ax, axis: int,
               lo: int = 1, hi: int = 1) -> jax.Array:
    """Attach lo/hi face slabs gathered from neighbor rows along one
    spatial axis.  x: (T + 1, d0, d1, d2, C); the pad row stays zero
    because its neighbors are itself."""
    ax = axis + 1
    parts = []
    if lo:
        face = jax.lax.slice_in_dim(x, x.shape[ax] - lo, x.shape[ax],
                                    axis=ax)
        parts.append(face[nb_lo_ax])
    parts.append(x)
    if hi:
        face = jax.lax.slice_in_dim(x, 0, hi, axis=ax)
        parts.append(face[nb_hi_ax])
    return jnp.concatenate(parts, axis=ax)


def halo(x: jax.Array, lvl: TileLevel, lo=(1, 1, 1),
         hi=(1, 1, 1)) -> jax.Array:
    """Multi-pass halo: axis k's pass gathers faces that already carry
    the halos of axes < k, so edge/corner tiles arrive for free."""
    for ax in range(3):
        if lo[ax] or hi[ax]:
            x = _halo_axis(x, lvl.nb_lo[:, ax], lvl.nb_hi[:, ax], ax,
                           lo[ax], hi[ax])
    return x


def _conv3d(x, w, stride=(1, 1, 1), padding="VALID",
            lhs_dilation=None, precision=None):
    return jax.lax.conv_general_dilated(
        x, w, window_strides=stride, padding=padding,
        lhs_dilation=lhs_dilation,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=precision, preferred_element_type=jnp.float32)


def _wconv(weights: jax.Array, kernel) -> jax.Array:
    """(K, Cin, Cout) tap-major (z, y, x meshgrid) -> DHWIO."""
    kz, ky, kx = kernel
    cin, cout = weights.shape[1], weights.shape[2]
    return weights.reshape(kz, ky, kx, cin, cout)


def subm_conv(x: jax.Array, lvl: TileLevel, weights, bias,
              compute_dtype=jnp.float32) -> jax.Array:
    """Submanifold 3x3x3 conv on tile blocks; output masked by occ."""
    h = halo(x, lvl).astype(compute_dtype)
    w = _wconv(weights, (3, 3, 3)).astype(compute_dtype)
    y = _conv3d(h, w) + bias
    return jnp.where(lvl.occ[..., None], y, 0.0)


def down_conv(x: jax.Array, fine: TileLevel, coarse: TileLevel,
              weights, bias, compute_dtype=jnp.float32) -> jax.Array:
    """k3 s2 p1 strided conv: fine tiles -> coarse tile blocks.

    Each fine tile owns the coarse cells [half*t, half*(t+1)) per dim,
    computed from its lo-haloed input; owned half-tile blocks scatter
    into the coarse level via 8 parity classes (statically-sliced
    octants, no overlap)."""
    h = halo(x, fine, lo=(1, 1, 1), hi=(0, 0, 0)).astype(compute_dtype)
    w = _wconv(weights, (3, 3, 3)).astype(compute_dtype)
    y = _conv3d(h, w, stride=(2, 2, 2)) + bias     # (T+1, hz, hy, hx, C)
    out = _scatter_half_blocks(y, fine, coarse.slot_map, coarse.tgrid,
                               coarse.capacity, coarse.tile)
    return jnp.where(coarse.occ[..., None], out, 0.0)


def _scatter_half_blocks(y, fine: TileLevel, coarse_slot_map,
                         coarse_tgrid, coarse_capacity: int,
                         coarse_tile):
    """Scatter per-fine-tile owned half blocks into coarse blocks.

    Requires coarse_tile == fine.tile (so 2 owned blocks fill a coarse
    tile per dim)."""
    assert tuple(coarse_tile) == tuple(fine.tile)
    hz, hy, hx = fine.half
    C = y.shape[-1]
    Tc = coarse_capacity
    out = jnp.zeros((Tc + 1,) + tuple(coarse_tile) + (C,), y.dtype)
    parent = fine.tile_coords // 2
    parity = fine.tile_coords % 2
    pid = _linearize(parent, coarse_tgrid)
    pslot = coarse_slot_map[
        jnp.minimum(pid, int(np.prod(coarse_tgrid)))] - 1
    for pz in range(2):
        for py in range(2):
            for px in range(2):
                sel = ((parity[:, 0] == pz) & (parity[:, 1] == py) &
                       (parity[:, 2] == px) & fine.tile_mask &
                       (pslot >= 0))
                tgt = jnp.where(sel, pslot, Tc)
                out = out.at[tgt, hz * pz:hz * (pz + 1),
                             hy * py:hy * (py + 1),
                             hx * px:hx * (px + 1), :].set(
                    jnp.where(sel[:, None, None, None, None],
                              y[:fine.capacity], 0.0))
    # the dump row collected junk; clear it
    return out.at[Tc].set(0.0)


def down_to_dense(x: jax.Array, fine: TileLevel, out_pad_shape,
                  weights, bias, occ_out,
                  compute_dtype=jnp.float32) -> jax.Array:
    """k3 s2 p1 strided conv: fine tiles -> DENSE (z, y, x, C) grid.

    out_pad_shape must equal fine.tgrid * fine.half (owned layout)."""
    h = halo(x, fine, lo=(1, 1, 1), hi=(0, 0, 0)).astype(compute_dtype)
    w = _wconv(weights, (3, 3, 3)).astype(compute_dtype)
    y = _conv3d(h, w, stride=(2, 2, 2)) + bias
    dense = _scatter_blocks_to_dense(y, fine, out_pad_shape)
    return jnp.where(occ_out[..., None], dense, 0.0)


def _scatter_blocks_to_dense(y, fine: TileLevel, out_pad_shape):
    """(T+1, hz, hy, hx, C) owned blocks -> dense grid tgrid * half."""
    C = y.shape[-1]
    tg = fine.tgrid
    hz, hy, hx = fine.half
    assert tuple(out_pad_shape) == (tg[0] * hz, tg[1] * hy,
                                    tg[2] * hx), (out_pad_shape, tg,
                                                  fine.half)
    nrows = tg[0] * tg[1] * tg[2]
    rid = _linearize(fine.tile_coords, tg)
    rid = jnp.where(fine.tile_mask, rid, nrows)
    rows = jnp.zeros((nrows + 1, hz, hy, hx, C), y.dtype)
    rows = rows.at[rid].set(
        jnp.where(fine.tile_mask[:, None, None, None, None],
                  y[:fine.capacity], 0.0))[:nrows]
    d = rows.reshape(tg + (hz, hy, hx, C))
    d = jnp.transpose(d, (0, 3, 1, 4, 2, 5, 6))
    return d.reshape(tuple(out_pad_shape) + (C,))


def _owned_occ_pool(lvl: TileLevel):
    """k3 s2 p1 activity dilation into the owned half-block layout."""
    h = halo(lvl.occ[..., None].astype(jnp.float32), lvl,
             lo=(1, 1, 1), hi=(0, 0, 0))[..., 0]
    return jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 3, 3, 3),
                                 (1, 2, 2, 2), "VALID")


def dense_occ_pool(occ, stride, kernel, padding):
    """Dense activity dilation (strided max-pool), bool in/out."""
    y = jax.lax.reduce_window(
        occ.astype(jnp.float32), -jnp.inf, jax.lax.max,
        tuple(kernel), tuple(stride), [tuple(p) for p in padding])
    return y > 0.0


def dense_subm_conv(x, occ, weights, bias, compute_dtype=jnp.float32):
    """Submanifold conv on a dense level (p=1, masked by occ)."""
    w = _wconv(weights, (3, 3, 3)).astype(compute_dtype)
    y = _conv3d(x[None].astype(compute_dtype), w,
                padding=[(1, 1)] * 3)[0] + bias
    return jnp.where(occ[..., None], y, 0.0)


def dense_down_conv(x, occ_out, weights, bias, kernel, stride, padding,
                    compute_dtype=jnp.float32):
    """Dense strided conv between dense levels."""
    w = _wconv(weights, kernel).astype(compute_dtype)
    y = _conv3d(x[None].astype(compute_dtype), w, stride=tuple(stride),
                padding=[(p, p) for p in padding])[0] + bias
    return jnp.where(occ_out[..., None], y, 0.0)


def _inv_blocks(regions, fine_tile, weights, bias, compute_dtype):
    """Shared inverse-conv core: (T+1, hz+1, hy+1, hx+1, Cin) coarse
    regions at offset half*t -> (T+1, tz, ty, tx, Cout) fine blocks.

    out(f) = sum_d w[d] in(c), f = 2c + d - 1  (k3 s2 p1 transposed).
    Implemented as kernel-flipped conv with lhs_dilation=2, padding 1;
    fine local f in [0, tile) is the leading slice of the output."""
    w = _wconv(weights, (3, 3, 3)).astype(compute_dtype)
    wf = w[::-1, ::-1, ::-1]
    y = _conv3d(regions.astype(compute_dtype), wf,
                lhs_dilation=(2, 2, 2), padding=[(1, 1)] * 3)
    tz, ty, tx = fine_tile
    return y[:, :tz, :ty, :tx, :] + bias


def inverse_from_dense(dense, fine: TileLevel, weights, bias,
                       compute_dtype=jnp.float32) -> jax.Array:
    """Inverse (transposed) conv from a DENSE coarse level onto the
    fine tile set (decoder L2 -> L1)."""
    hz, hy, hx = fine.half
    reg = (hz + 1, hy + 1, hx + 1)
    pad = jnp.pad(dense, ((0, reg[0]), (0, reg[1]), (0, reg[2]), (0, 0)))
    starts = fine.tile_coords * jnp.asarray((hz, hy, hx), jnp.int32)

    def grab(s):
        return jax.lax.dynamic_slice(
            pad, (s[0], s[1], s[2], 0), reg + (dense.shape[-1],))

    regions = jax.vmap(grab)(starts)
    regions = jnp.concatenate(
        [regions, jnp.zeros((1,) + regions.shape[1:], regions.dtype)], 0)
    y = _inv_blocks(regions, fine.tile, weights, bias, compute_dtype)
    return jnp.where(fine.occ[..., None], y, 0.0)


def inverse_from_tiles(xc: jax.Array, coarse: TileLevel,
                       fine: TileLevel, weights, bias,
                       compute_dtype=jnp.float32) -> jax.Array:
    """Inverse conv from a TILED coarse level onto the fine tile set
    (decoder L1 -> L0).  Fine tile t needs coarse cells
    [half*t, half*(t+1)]: assemble hi-haloed coarse blocks, gather each
    fine tile's parent, slice at the half*parity octant."""
    assert tuple(coarse.tile) == tuple(fine.tile)
    hz, hy, hx = fine.half
    hc = halo(xc, coarse, lo=(0, 0, 0), hi=(1, 1, 1))
    parent = fine.tile_coords // 2
    parity = fine.tile_coords % 2
    pid = _linearize(parent, coarse.tgrid)
    pslot = coarse.slot_map[
        jnp.minimum(pid, int(np.prod(coarse.tgrid)))] - 1
    pslot = jnp.where((pslot >= 0) & fine.tile_mask, pslot,
                      coarse.capacity)
    C = xc.shape[-1]
    regions = jnp.zeros((fine.capacity + 1, hz + 1, hy + 1, hx + 1, C),
                        xc.dtype)
    for pz in range(2):
        for py in range(2):
            for px in range(2):
                sel = ((parity[:, 0] == pz) & (parity[:, 1] == py) &
                       (parity[:, 2] == px))
                src = hc[jnp.where(sel, pslot, coarse.capacity),
                         hz * pz:hz * (pz + 1) + 1,
                         hy * py:hy * (py + 1) + 1,
                         hx * px:hx * (px + 1) + 1, :]
                regions = regions.at[:fine.capacity].set(
                    jnp.where(sel[:, None, None, None, None], src,
                              regions[:fine.capacity]))
    y = _inv_blocks(regions, fine.tile, weights, bias, compute_dtype)
    return jnp.where(fine.occ[..., None], y, 0.0)


def zcollapse_conv(x, occ_out, weights, bias, compute_dtype=jnp.float32):
    """(3,1,1) s(2,1,1) p0 dense conv (L3 -> L4 z collapse)."""
    w = _wconv(weights, (3, 1, 1)).astype(compute_dtype)
    y = _conv3d(x[None].astype(compute_dtype), w, stride=(2, 1, 1),
                padding=[(0, 0)] * 3)[0] + bias
    return jnp.where(occ_out[..., None], y, 0.0)


def build_tiled_geometry(coords: jax.Array, vmask: jax.Array,
                         sparse_shape, tile_capacities,
                         tile=DEFAULT_TILE) -> TiledGeometry:
    """Full per-frame geometry: L0/L1 tile levels + dense L2-L4 occ.

    sparse_shape: (nz, ny, nx) with the +1 z pad applied (net.py).
    tile_capacities: (T0, T1) static tile capacities; clamped to the
    tile-grid size so small grids can never overflow."""
    T0, T1 = tile_capacities
    tile = tuple(tile)
    assert all(t % 2 == 0 for t in tile), tile
    tg0 = tuple(_cdiv(sparse_shape[d], tile[d]) for d in range(3))
    T0 = min(T0, int(np.prod(tg0)))
    l0, cell_index = build_l0(coords, vmask, sparse_shape, T0, tile)
    half = l0.half

    # L1 grid (k3 s2 p1 per dim)
    g1 = tuple((sparse_shape[d] + 2 - 3) // 2 + 1 for d in range(3))
    tg1 = tuple(_cdiv(g1[d], tile[d]) for d in range(3))
    T1 = min(T1, int(np.prod(tg1)))
    # L1 occupancy: pool L0 occ into owned half blocks, lay out densely
    # over the owned grid (tg0 * half, covers >= g1), then re-tile
    pooled = _owned_occ_pool(l0)
    occ1_pad = _scatter_blocks_to_dense(
        pooled[..., None], l0,
        tuple(tg0[d] * half[d] for d in range(3)))[..., 0] > 0.0
    ext1 = tuple(tg1[d] * tile[d] for d in range(3))
    occ1_d = jnp.zeros(ext1, bool)
    sl = tuple(slice(0, min(ext1[d], occ1_pad.shape[d]))
               for d in range(3))
    occ1_d = occ1_d.at[sl].set(occ1_pad[sl])
    for d, g in enumerate(g1):   # kill cells beyond the true grid
        idx = [slice(None)] * 3
        idx[d] = slice(g, None)
        occ1_d = occ1_d.at[tuple(idx)].set(False)
    blocks6 = occ1_d.reshape(tg1[0], tile[0], tg1[1], tile[1],
                             tg1[2], tile[2])
    tflag1 = blocks6.any((1, 3, 5)).reshape(-1)
    c1, m1, sm1, nlo1, nhi1 = _build_level(tflag1, tg1, g1, tile, T1)
    occ1_rows = jnp.transpose(blocks6, (0, 2, 4, 1, 3, 5)).reshape(
        (-1,) + tile)
    rid1 = jnp.where(m1, _linearize(c1, tg1), occ1_rows.shape[0])
    occ1_rows = jnp.concatenate(
        [occ1_rows, jnp.zeros((1,) + tile, bool)], 0)
    occ1 = jnp.concatenate(
        [occ1_rows[rid1], jnp.zeros((1,) + tile, bool)], 0)
    l1 = TileLevel(c1, m1, sm1, nlo1, nhi1, occ1, g1, tg1, tile)

    # dense levels
    g2 = tuple((g1[d] + 2 - 3) // 2 + 1 for d in range(3))
    pad2 = tuple(tg1[d] * half[d] for d in range(3))
    occ2 = _scatter_blocks_to_dense(
        _owned_occ_pool(l1)[..., None], l1, pad2)[..., 0] > 0.0
    for d, g in enumerate(g2):
        idx = [slice(None)] * 3
        idx[d] = slice(g, None)
        occ2 = occ2.at[tuple(idx)].set(False)

    # L3: k3 s2, z unpadded, y/x p=1 — on the true-grid semantics
    g3 = ((g2[0] - 3) // 2 + 1,
          (g2[1] + 2 - 3) // 2 + 1, (g2[2] + 2 - 3) // 2 + 1)
    occ3 = dense_occ_pool(occ2, (2, 2, 2), (3, 3, 3),
                          ((0, 0), (1, 1), (1, 1)))
    occ3 = occ3[:g3[0], :g3[1], :g3[2]]
    # L4: k(3,1,1) s(2,1,1) p0
    g4 = ((g3[0] - 3) // 2 + 1, g3[1], g3[2])
    occ4 = dense_occ_pool(occ3, (2, 1, 1), (3, 1, 1),
                          ((0, 0), (0, 0), (0, 0)))
    occ4 = occ4[:g4[0], :g4[1], :g4[2]]
    return TiledGeometry(l0, l1, cell_index, occ2, occ3, occ4)
