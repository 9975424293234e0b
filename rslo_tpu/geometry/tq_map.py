"""Dense local-transformation (tq) maps over the BEV grid.

A global ego-motion pose ``[t_g, q_g]`` is encoded per grid cell as the
*local* pose observed at that cell's world coordinate ``c``:

    ``t_l(c) = R(q_g)^-1 (t_g - c) + c``,  ``q_l(c) = q_g``

and decoded back with ``t_g(c) = R(q_l) (t_l - c) + c`` (reference
semantics: /root/reference/rslo/data/dataset.py:52-208).

Layout: maps are channels-last ``(..., H, W, 7)`` with H indexed by the
grid row ``i`` (world y decreasing) and W by column ``j`` (world x
increasing), matching the reference's (y, x) raster:

    ``x(j) = (j - ox) * vx``,  ``y(i) = (oy - i) * vy``,  ``z(k) = (k - oz) * vz``

The reference stores maps channels-first; we keep channels-last (the
layout XLA's convolutions prefer) and transpose only at I/O boundaries
if ever needed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .quaternion import qinv, qnormalize, rotate_vec_by_q


def grid_cell_coords(spatial_size, pc_range, dtype=jnp.float32) -> jax.Array:
    """World xyz of each BEV cell anchor, shape (H, W, 3).

    ``spatial_size`` is (H, W) or (H, W, D); pc_range is the 6-vector
    [x0, y0, z0, x1, y1, z1].  The anchor convention matches the reference
    (cell's "left-top" corner, no half-cell shift), with the origin cell
    chosen so that world (0, 0, 0) lands at fractional grid position
    ``(ox, oy, oz)`` computed from pc_range.
    """
    if len(spatial_size) == 2:
        H, W = spatial_size
        D = 1
    else:
        H, W, D = spatial_size
    pc_range = np.asarray(pc_range, np.float64)
    # grid size in (x, y, z) order = (W, H, D)
    gs = np.array([W, H, D], np.float64)
    voxel_size = (pc_range[3:] - pc_range[:3]) / gs
    ox = (0.0 - pc_range[0]) / (pc_range[3] - pc_range[0]) * W
    oy = (pc_range[4] - 0.0) / (pc_range[4] - pc_range[1]) * H
    oz = (0.0 - pc_range[2]) / (pc_range[5] - pc_range[2]) * D

    i = jnp.arange(H, dtype=dtype)[:, None, None]
    j = jnp.arange(W, dtype=dtype)[None, :, None]
    k = jnp.arange(D, dtype=dtype)[None, None, :]
    xv = (j - ox) * voxel_size[0]
    yv = (oy - i) * voxel_size[1]
    zv = (k - oz) * voxel_size[2]
    xyz = jnp.stack(jnp.broadcast_arrays(xv, yv, zv), axis=-1)  # (H, W, D, 3)
    if len(spatial_size) == 2:
        xyz = xyz[:, :, 0, :]
    return xyz.astype(dtype)


def _warp_coords(coords: jax.Array, inv_trans_factor: float) -> jax.Array:
    """Reference's optional inverse-distance xy warp of the anchor
    coordinates (``inv_trans_factor`` branch,
    /root/reference/rslo/data/kitti_dataset_hdf5.py:549-552): cells are
    re-anchored at ``f / (|xy| + 0.1)^2 * xy`` so near-field cells carry
    far anchors and vice versa.  Used identically by encode and decode,
    so the map stays exactly invertible."""
    if inv_trans_factor <= 0:
        return coords
    xy = coords[..., :2]
    r = jnp.sqrt(jnp.sum(xy * xy, axis=-1, keepdims=True)) + 0.1
    return jnp.concatenate(
        [inv_trans_factor / (r * r) * xy, coords[..., 2:]], axis=-1)


def generate_tq_map(tq: jax.Array, spatial_size, pc_range,
                    inv_trans_factor: float = -1.0) -> jax.Array:
    """Encode global pose(s) ``tq`` (..., 7) into a local tq map.

    ``spatial_size`` (H, W) gives the BEV map (..., H, W, 7);
    (H, W, D) gives the cubic/3D variant (..., H, W, D, 7) — the
    reference's `generate_pointwise_local_transformation[_tch]` 3D
    branch (/root/reference/rslo/data/kitti_dataset_hdf5.py:511-631).
    """
    coords = grid_cell_coords(spatial_size, pc_range, dtype=tq.dtype)
    coords = _warp_coords(coords, inv_trans_factor)
    nd = coords.ndim - 1                     # 2 (H,W) or 3 (H,W,D)
    expand = (None,) * nd
    t_g = tq[(..., *expand, slice(0, 3))]
    q_g = tq[(..., *expand, slice(3, 7))]
    t_l = rotate_vec_by_q(t_g - coords, qinv(q_g)) + coords
    q_map = jnp.broadcast_to(q_g, t_l.shape[:-1] + (4,))
    return jnp.concatenate([t_l, q_map], axis=-1)


def decode_tq_map(tq_map: jax.Array, pc_range, dims: int = 2,
                  inv_trans_factor: float = -1.0) -> jax.Array:
    """Decode a local tq map back to per-cell global poses.

    ``dims=2``: (..., H, W, 7) BEV map; ``dims=3``: (..., H, W, D, 7)
    cubic map.  Returns the same shape where every cell carries its
    vote for the global motion; quaternions are re-normalized.
    """
    spatial = tuple(tq_map.shape[-(dims + 1):-1])
    coords = grid_cell_coords(spatial, pc_range, dtype=tq_map.dtype)
    coords = _warp_coords(coords, inv_trans_factor)
    t_l = tq_map[..., :3]
    q_l = tq_map[..., 3:]
    t_g = rotate_vec_by_q(t_l - coords, q_l) + coords
    return jnp.concatenate([t_g, qnormalize(q_l)], axis=-1)
