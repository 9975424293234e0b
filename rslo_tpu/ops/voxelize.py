"""Fixed-capacity point-cloud voxelization as a pure-JAX op.

Replacement for the reference's C++ ``spconv.utils.VoxelGenerator``
(used at /root/reference/rslo/builder/voxel_builder.py:36-95 and
rslo/data/preprocess.py:469-512): buckets points into voxels of
``voxel_size`` over ``point_cloud_range``, keeping at most ``max_points``
points per voxel and ``max_voxels`` voxels.  Everything is static-shape:
invalid slots are zero-filled and masked via ``num_points``.

Differences from the reference (deliberate, documented):
  * Voxels come out sorted by linearized (z, y, x) coordinate instead of
    point-arrival order.  The set of voxels is identical while under
    capacity; over capacity the overflow policy differs (we drop largest
    ids, the reference drops latest arrivals).
  * Within a voxel, points keep their input order (stable sort), matching
    the reference's first-`max_points` policy.
  * The optional block ground-filter (``height_threshold``) follows the
    reference's semantics of dropping points lower than
    ``block_min_z + height_threshold`` per BEV block; the shipped configs
    set ``height_threshold = -1`` which disables it, and so do we by
    default.

Coordinates are returned in (z, y, x) order like the reference, ready for
the sparse middle net.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class VoxelizerConfig(NamedTuple):
    point_cloud_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple         # (vx, vy, vz)
    max_points: int = 10
    max_voxels: int = 40000
    height_threshold: float = -1.0
    block_size: int = 8       # BEV block edge (in voxels) for ground filter

    @property
    def grid_size(self) -> np.ndarray:
        """(nx, ny, nz) — x, y, z order like the reference's grid_size."""
        pr = np.asarray(self.point_cloud_range, np.float64)
        vs = np.asarray(self.voxel_size, np.float64)
        return np.round((pr[3:] - pr[:3]) / vs).astype(np.int64)


class Voxels(NamedTuple):
    """Static-shape voxelization result.

    voxels:      (V, P, F) per-voxel point stacks, zero-padded.
    coords:      (V, 3) int32 voxel coordinates in (z, y, x); -1 on padding.
    num_points:  (V,) int32 number of valid points in each voxel slot.
    num_voxels:  () int32 number of valid voxel slots.
    point_voxel: (N,) int32 index of the voxel slot each input point went to
                 (-1 if dropped) — used by downstream scatter/gather ops.
    """
    voxels: jax.Array
    coords: jax.Array
    num_points: jax.Array
    num_voxels: jax.Array
    point_voxel: jax.Array

    @property
    def mask(self) -> jax.Array:
        """(V,) bool validity of voxel slots."""
        return self.num_points > 0


def _sort_and_slot(points: jax.Array, point_mask: jax.Array,
                   config: VoxelizerConfig):
    """Shared grid-binning + stable argsort + slot/rank assignment.

    Returns (order, slot, rnk, keep, head, voxel_slot, czyx) where
    ``slot`` routes sorted points to voxel slots (drop bin = V) and
    ``keep`` applies validity + capacity + per-voxel point cap."""
    N = points.shape[0]
    V, P = config.max_voxels, config.max_points
    pr = jnp.asarray(config.point_cloud_range, points.dtype)
    vs = jnp.asarray(config.voxel_size, points.dtype)
    nx, ny, nz = (int(g) for g in config.grid_size)

    xyz = points[:, :3]
    cxyz = jnp.floor((xyz - pr[:3]) / vs).astype(jnp.int32)  # (N,3) x,y,z
    in_range = jnp.all((cxyz >= 0) & (cxyz < jnp.array([nx, ny, nz])), axis=-1)
    valid = in_range & point_mask

    if config.height_threshold >= 0:
        # Ground filter: per BEV block (block_size voxels square), drop
        # points below block_min_z + height_threshold.
        bx = (nx + config.block_size - 1) // config.block_size
        by = (ny + config.block_size - 1) // config.block_size
        bid = (cxyz[:, 1] // config.block_size) * bx + \
            (cxyz[:, 0] // config.block_size)
        bid = jnp.where(valid, bid, bx * by)  # park invalid in extra bin
        zbig = jnp.where(valid, xyz[:, 2], jnp.inf)
        block_min = jnp.full((bx * by + 1,), jnp.inf, points.dtype)
        block_min = block_min.at[bid].min(zbig)
        valid = valid & (xyz[:, 2] >= block_min[bid] +
                         config.height_threshold)

    # Linear voxel id in (z, y, x) major order; invalid -> sentinel (max).
    vid = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
    sentinel = nx * ny * nz
    vid = jnp.where(valid, vid, sentinel)

    order = jnp.argsort(vid, stable=True)          # (N,)
    svid = vid[order]
    # Segment heads in the sorted stream.
    head = jnp.concatenate([jnp.array([True]),
                            svid[1:] != svid[:-1]]) & (svid < sentinel)
    voxel_slot = jnp.cumsum(head.astype(jnp.int32)) - 1     # (N,) slot per pt
    # Rank of each point within its voxel: position - segment start.
    pos = jnp.arange(N, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(head, pos, -1))
    rank = pos - seg_start

    keep = (svid < sentinel) & (voxel_slot < V) & (rank < P)
    slot = jnp.where(keep, voxel_slot, V)      # scatter-drop bin V
    rnk = jnp.where(keep, rank, 0)
    czyx = cxyz[order][:, ::-1]
    return order, slot, rnk, keep, head, voxel_slot, czyx


@functools.partial(jax.jit, static_argnames=("config",))
def voxelize(points: jax.Array, point_mask: jax.Array,
             config: VoxelizerConfig) -> Voxels:
    """Voxelize a padded point cloud.

    Args:
      points: (N, F) float array; columns 0:3 are x, y, z.
      point_mask: (N,) bool validity of each point row.
      config: static voxelizer parameters.
    """
    N = points.shape[0]
    V, P = config.max_voxels, config.max_points
    order, slot, rnk, keep, head, voxel_slot, czyx = _sort_and_slot(
        points, point_mask, config)

    voxels = jnp.zeros((V + 1, P) + points.shape[1:], points.dtype)
    voxels = voxels.at[slot, rnk].set(
        jnp.where(keep[:, None], points[order], 0.0))[:V]

    num_points = jnp.zeros((V + 1,), jnp.int32).at[slot].add(
        keep.astype(jnp.int32))[:V]

    # Coordinates per slot, (z, y, x); -1 padding.
    coords = jnp.full((V + 1, 3), -1, jnp.int32)
    coords = coords.at[slot].set(
        jnp.where(keep[:, None], czyx, -1))[:V]

    num_voxels = jnp.sum(head & (voxel_slot < V)).astype(jnp.int32)

    # Map each ORIGINAL point row to its voxel slot (-1 if dropped).
    pv_sorted = jnp.where(keep, slot, -1)
    point_voxel = jnp.zeros((N,), jnp.int32).at[order].set(pv_sorted)
    return Voxels(voxels, coords, num_points, num_voxels, point_voxel)


class MeanVoxels(NamedTuple):
    """Sort-free voxelization result (mean features only).

    features:   (V, F) per-voxel mean of point features.
    coords:     (V, 3) int32 (z, y, x); -1 padding.  Slots are in
                ascending linear-id order (same invariant as `voxelize`).
    num_points: (V,) int32 points per voxel (ALL points — no per-voxel
                cap, unlike the stack-based path).
    num_voxels: () int32.
    point_voxel:(N,) int32 slot per input point (-1 dropped).
    """
    features: jax.Array
    coords: jax.Array
    num_points: jax.Array
    num_voxels: jax.Array
    point_voxel: jax.Array

    @property
    def mask(self) -> jax.Array:
        return self.num_points > 0


@functools.partial(jax.jit, static_argnames=("config",))
def voxelize_mean(points: jax.Array, point_mask: jax.Array,
                  config: VoxelizerConfig) -> MeanVoxels:
    """Sort-free voxelization: compaction via a two-level prefix sum
    over the dense occupancy grid instead of a 131k argsort.  Produces per-voxel MEANS
    directly — sufficient for the mean VFEs and the pillar path; use
    :func:`voxelize` when per-voxel point stacks are needed.

    Overflow policy matches `voxelize`: slots are id-ordered and cells
    beyond ``max_voxels`` are dropped (largest ids).  Difference: means
    include ALL of a voxel's points (no ``max_points`` arrival cap).
    """
    N, F = points.shape
    V = config.max_voxels
    pr = jnp.asarray(config.point_cloud_range, points.dtype)
    vs = jnp.asarray(config.voxel_size, points.dtype)
    nx, ny, nz = (int(g) for g in config.grid_size)
    G = nx * ny * nz

    xyz = points[:, :3]
    cxyz = jnp.floor((xyz - pr[:3]) / vs).astype(jnp.int32)
    valid = jnp.all((cxyz >= 0) & (cxyz < jnp.array([nx, ny, nz])),
                    axis=-1) & point_mask
    vid = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
    vid = jnp.where(valid, vid, G)

    # occupancy bitmap + two-level exclusive prefix sum -> slot per id
    occ = jnp.zeros((G + 1,), jnp.int32).at[vid].max(1)
    occ = occ[:G]
    R = nz * ny                      # rows of the 2D scan layout
    occ2d = occ.reshape(R, nx)
    row_c = jnp.cumsum(occ2d, axis=1)
    row_off = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(row_c[:, -1])[:-1]])
    csum_excl = (row_off[:, None] + row_c - occ2d).reshape(-1)  # (G,)
    n_active = (row_off[-1] + row_c[-1, -1]).astype(jnp.int32)

    slot_all = jnp.concatenate([csum_excl, jnp.full((1,), V, jnp.int32)])
    pslot = slot_all[vid]
    keep = valid & (pslot < V)
    pslot = jnp.where(keep, pslot, V)

    feat_sum = jnp.zeros((V + 1, F), points.dtype).at[pslot].add(
        jnp.where(keep[:, None], points, 0.0))
    count = jnp.zeros((V + 1,), jnp.int32).at[pslot].add(
        keep.astype(jnp.int32))
    features = feat_sum[:V] / jnp.maximum(count[:V, None], 1)

    # coords per slot: min-scatter of ids (all points in a slot share id)
    ids_arr = jnp.full((V + 1,), G, jnp.int32).at[pslot].min(
        jnp.where(keep, jnp.minimum(vid, G), G))
    ids_arr = ids_arr[:V]
    mask_v = count[:V] > 0
    zz = ids_arr // (ny * nx)
    yy = (ids_arr // nx) % ny
    xx = ids_arr % nx
    coords = jnp.where(mask_v[:, None],
                       jnp.stack([zz, yy, xx], -1), -1).astype(jnp.int32)
    features = jnp.where(mask_v[:, None], features, 0.0)
    point_voxel = jnp.where(keep, pslot, -1).astype(jnp.int32)
    return MeanVoxels(features, coords, count[:V],
                      jnp.minimum(n_active, V), point_voxel)


def voxelize_np(points: np.ndarray, config: VoxelizerConfig):
    """Numpy oracle with the same semantics (for tests and host prep)."""
    mask = np.ones(len(points), bool)
    out = voxelize(jnp.asarray(points), jnp.asarray(mask), config)
    return jax.tree.map(np.asarray, out)


@functools.partial(jax.jit, static_argnames=("config",))
def voxelize_sorted_mean(points: jax.Array, point_mask: jax.Array,
                         config: VoxelizerConfig) -> MeanVoxels:
    """Argsort-based voxelization emitting per-voxel MEAN features.

    Semantics are identical to ``voxelize`` followed by a mean-style
    VFE — the same per-voxel ``max_points`` cap applies (only the first
    P points of each voxel, in stable-sorted order, contribute to the
    mean), so the deployed SimpleVoxel_XYZINormalC pipeline (reference
    rslo/models/voxel_encoder.py:258-280) produces matching features
    from either path.

    Memory-lean formulation (the voxelizer is latency-bound, ~40% of
    the r2 inference pipeline): the sort carries (vid, iota) in ONE
    ``lax.sort`` (no vid[order] re-gather); the sorted order is only
    used to derive each point's slot/cap, which is routed back to the
    ORIGINAL rows with one int32 scatter — the (N, F) feature rows are
    then scatter-added UNSORTED (scatter-add is order-independent, and
    the stable sort preserves original within-voxel order anyway) with
    a fused ones-column producing the counts, skipping the (N, F) row
    gather, the (N, 3) coords row scatter, and the separate counts
    scatter of the previous formulation.  Coords decode arithmetically
    from a scatter-min of the linear ids."""
    N = points.shape[0]
    V, P = config.max_voxels, config.max_points
    F = points.shape[1]
    pr = jnp.asarray(config.point_cloud_range, points.dtype)
    vs = jnp.asarray(config.voxel_size, points.dtype)
    nx, ny, nz = (int(g) for g in config.grid_size)

    xyz = points[:, :3]
    cxyz = jnp.floor((xyz - pr[:3]) / vs).astype(jnp.int32)
    valid = jnp.all((cxyz >= 0) & (cxyz < jnp.array([nx, ny, nz])),
                    axis=-1) & point_mask
    vid = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
    sentinel = nx * ny * nz
    vid = jnp.where(valid, vid, sentinel)

    iota = jnp.arange(N, dtype=jnp.int32)
    svid, order = jax.lax.sort((vid, iota), is_stable=True, num_keys=1)
    head = jnp.concatenate([jnp.array([True]),
                            svid[1:] != svid[:-1]]) & (svid < sentinel)
    voxel_slot = jnp.cumsum(head.astype(jnp.int32)) - 1
    seg_start = jax.lax.cummax(jnp.where(head, iota, -1))
    rank = iota - seg_start
    keep_s = (svid < sentinel) & (voxel_slot < V) & (rank < P)
    slot_s = jnp.where(keep_s, voxel_slot, V)          # V = drop bin

    # route each SORTED row's slot back to its original row (int32)
    pslot = jnp.zeros((N,), jnp.int32).at[order].set(slot_s)
    keep = pslot < V

    # one fused (N, F+1) scatter-add: feature sums + counts together
    feat_ext = jnp.concatenate(
        [points, jnp.ones((N, 1), points.dtype)], axis=1)
    fsum_ext = jnp.zeros((V + 1, F + 1), points.dtype).at[pslot].add(
        jnp.where(keep[:, None], feat_ext, 0.0))[:V]
    num_points = fsum_ext[:, F].astype(jnp.int32)
    mean = fsum_ext[:, :F] / jnp.maximum(
        num_points, 1)[:, None].astype(points.dtype)

    # coords: scatter-min of linear ids (all kept points in a slot
    # share one id), decoded arithmetically — no (N, 3) row scatter
    ids_arr = jnp.full((V + 1,), sentinel, jnp.int32).at[pslot].min(
        jnp.where(keep, vid, sentinel))[:V]
    mask_v = num_points > 0
    zz = ids_arr // (ny * nx)
    yy = (ids_arr // nx) % ny
    xx = ids_arr % nx
    coords = jnp.where(mask_v[:, None],
                       jnp.stack([zz, yy, xx], -1), -1).astype(jnp.int32)
    mean = jnp.where(mask_v[:, None], mean, 0.0)

    num_voxels = jnp.sum(head & (voxel_slot < V)).astype(jnp.int32)
    point_voxel = jnp.where(keep, pslot, -1).astype(jnp.int32)
    return MeanVoxels(mean, coords, num_points, num_voxels, point_voxel)
