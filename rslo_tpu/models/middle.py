"""Sparse 3D middle feature extractor + per-voxel covariance decoder.

Re-design of the reference's SpMiddleFHDWithCov2_3
(/root/reference/rslo/models/middle.py:36-245): the same channel plan
(16-16 @ full res → 32-32 @ 1/2 → 64s @ 1/4, 1/8 → z-collapse → dense
BEV at 1/8 with C*D=128 channels) plus an inverse-conv decoder from the
1/4-res level back to full resolution emitting 7 covariance parameters
per active voxel (cumulative eigenvalues through elu+1 + eigvec
quaternion).

Two interchangeable execution engines share one parameter tree (same
module order/names, so checkpoints and equivalence tests carry over):

  * ``engine="rulebook"`` — sorted-level/rulebook gather-matmul
    (:mod:`rslo_tpu.ops.sparse_conv`); architecture-exact oracle.
  * ``engine="tiles"`` — tiled dense blocks + batched ``lax.conv``
    (:mod:`rslo_tpu.ops.tiled_conv`); whole-tile reads instead of
    64 B row gathers, no sorts/rulebooks.
  * ``engine="band"`` — rulebook geometry with banded one-hot gathers
    (:mod:`rslo_tpu.ops.band_conv`).

Geometry is built once per frame and shared by all layers at the same
resolution — the analog of spconv's ``indice_key``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from .. import nn

from ..config.schema import MiddleCfg
from ..utils.mesh_axis import axis_present
from ..ops import band_conv as bc
from ..ops import sparse_conv as sc
from ..ops import tiled_conv as tc


class FrameGeometry(NamedTuple):
    """Per-frame sparse geometry shared across layers (indice_key analog)."""
    levels: tuple          # L0 (full res) .. L4 (z-collapsed)
    sub_rb: tuple          # submanifold rulebooks for L0..L3
    down_rb: tuple         # strided-conv rulebooks L0->L1, L1->L2, L2->L3, L3->L4
    inv_rb: tuple          # inverse rulebooks L2->L1, L1->L0


DOWN_SPECS = (
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # L0 -> L1
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # L1 -> L2
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),   # L2 -> L3 (z unpadded)
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),   # L3 -> L4 (z collapse)
)


def build_geometry(coords: jax.Array, mask: jax.Array, sparse_shape,
                   capacities, lookup: str | None = None) -> FrameGeometry:
    """coords: (V, 3) zyx int32; sparse_shape: (nz, ny, nx) with the
    reference's +1 on z already applied; capacities: per-level static caps
    (L4 reuses the L3 capacity).

    lookup: rulebook lookup method — None/'slot_map' (dense id->slot
    table, one random gather per (row, tap)), 'ranked' (windowed
    compare-reduce ranks, no slot maps; see sparse_conv._lookup_ranked),
    or 'ranked_planes'/'sorted_planes' (3x fewer lookups: one rank
    query per (dz, dy) kernel plane, x-offset taps derived from id
    adjacency — sparse_conv.build_submanifold_index_planes; rank via
    the windowed path resp. plain searchsorted).
    """
    no_slot = lookup in ("ranked", "ranked_planes", "sorted_planes")
    planes = lookup in ("ranked_planes", "sorted_planes")
    slot_planes = lookup == "slot_planes"
    rank_method = "ranked" if lookup == "ranked_planes" else "sorted"
    # the non-plane lookups (inverse rulebooks, L3->L4 z-collapse)
    # fall back to the matching elementwise method
    elt_lookup = ("ranked" if lookup == "ranked_planes" else
                  None if lookup in ("sorted_planes", "slot_planes")
                  else lookup)
    attach = (lambda l: l) if no_slot else sc.with_slot_map
    l0 = attach(sc.level_from_coords(coords, mask, sparse_shape))
    levels = [l0]
    down_rb = []
    caps = list(capacities) + [capacities[-1]]
    for i, (k, s, p) in enumerate(DOWN_SPECS):
        nxt = sc.downsample_level(levels[-1], k, s, p,
                                  out_capacity=caps[min(i + 1, len(caps) - 1)])
        if i < len(DOWN_SPECS) - 1:  # L4 is never looked up in
            nxt = attach(nxt)
        if planes and k[2] == 3 and p[2] == 1:
            down_rb.append(sc.build_conv_index_planes(
                levels[-1], nxt, k, s, p, rank_method=rank_method))
        elif slot_planes and k[2] == 3 and p[2] == 1:
            down_rb.append(sc.build_conv_index_slot_planes(
                levels[-1], nxt, k, s, p))
        else:
            down_rb.append(sc.build_conv_index(levels[-1], nxt, k, s, p,
                                               lookup=elt_lookup))
        levels.append(nxt)
    if planes:
        sub_rb = tuple(sc.build_submanifold_index_planes(
            l, rank_method=rank_method) for l in levels[:4])
    elif slot_planes:
        sub_rb = tuple(sc.build_submanifold_index_slot_planes(l)
                       for l in levels[:4])
    else:
        sub_rb = tuple(sc.build_submanifold_index(l, lookup=elt_lookup)
                       for l in levels[:4])
    inv_rb = (
        sc.build_inverse_index(levels[2], levels[1], *DOWN_SPECS[1],
                               lookup=elt_lookup),
        sc.build_inverse_index(levels[1], levels[0], *DOWN_SPECS[0],
                               lookup=elt_lookup),
    )
    return FrameGeometry(tuple(levels), sub_rb, tuple(down_rb), inv_rb)


def build_tiled_geometry(coords, mask, sparse_shape, tile_capacities,
                         tile=tc.DEFAULT_TILE) -> tc.TiledGeometry:
    return tc.build_tiled_geometry(coords, mask, sparse_shape,
                                   tile_capacities, tile)


def build_band_geometry(coords: jax.Array, mask: jax.Array, sparse_shape,
                        capacities, windows=(bc.SUBM_WINDOW,
                                             bc.DOWN_WINDOW,
                                             bc.INV_WINDOW),
                        block: int = 256,
                        channels=None,
                        min_channels: int = 0,
                        lookup: str | None = None) -> FrameGeometry:
    """Rulebook geometry with ConvIndexes wrapped into banded one-hot
    gather plans (ops/band_conv.py) — same FrameGeometry shape, so the
    plan/provider machinery is shared with the rulebook engine.

    Per-level engine dispatch: the one-hot formulation does W/B times
    the work of a row gather, which pays least at narrow channels.
    When ``channels`` (the middle net's (c0, c1, c2, c3) plan) is
    given, rulebooks whose widest conv runs below ``min_channels`` are
    left as raw ConvIndex so SpConv routes them through the row-gather
    path; the wide levels get band plans.  min_channels=0 wraps
    everything.
    """
    geo = build_geometry(coords, mask, sparse_shape, capacities,
                         lookup=lookup)
    sw, dw, iw = windows

    if channels is None:
        ch = (min_channels,) * 4  # no info -> wrap everything
    else:
        ch = tuple(channels)
    # widest conv through each rulebook (encoder + cov decoder reuse):
    sub_w = ch                                     # subm L_i: c_i -> c_i
    down_w = tuple(max(ch[i], ch[min(i + 1, 3)]) for i in range(4))
    inv_w = (max(ch[2], ch[1]), max(ch[1], ch[0]))

    def wrap(rb, v_in, window, width):
        if width < min_channels:
            return rb  # narrow level: keep the XLA row-gather path
        return bc.build_band_index(rb, v_in, block=block, window=window)

    sub = tuple(wrap(rb, geo.levels[i].capacity, sw, sub_w[i])
                for i, rb in enumerate(geo.sub_rb))
    down = tuple(wrap(rb, geo.levels[i].capacity, dw, down_w[i])
                 for i, rb in enumerate(geo.down_rb))
    inv = (wrap(geo.inv_rb[0], geo.levels[2].capacity, iw, inv_w[0]),
           wrap(geo.inv_rb[1], geo.levels[1].capacity, iw, inv_w[1]))
    return FrameGeometry(geo.levels, sub, down, inv)


def band_overflow_counts(geo: FrameGeometry):
    """Per-plan (ov_count, ov_capacity) diagnostics for every banded
    rulebook in the geometry — the deployment guard against the
    documented-inexact overflow-saturation path (band_conv.py)."""
    out = {}
    for name, rbs in (("sub", geo.sub_rb), ("down", geo.down_rb),
                      ("inv", geo.inv_rb)):
        for i, rb in enumerate(rbs):
            if isinstance(rb, bc.BandIndex) and rb.ov_count is not None:
                out[f"{name}{i}"] = (rb.ov_count, rb.ov_capacity)
    return out


# ---- engine-dispatch op descriptors (consumed by SpConv) -----------------

class SubmOp(NamedTuple):
    lvl: tc.TileLevel


class DownOp(NamedTuple):
    fine: tc.TileLevel
    coarse: tc.TileLevel


class DownDenseOp(NamedTuple):
    fine: tc.TileLevel
    out_pad_shape: tuple
    occ_out: jax.Array


class DenseSubmOp(NamedTuple):
    occ: jax.Array


class DenseDownOp(NamedTuple):
    occ_out: jax.Array
    kernel: tuple
    stride: tuple
    padding: tuple


class InvDenseOp(NamedTuple):
    fine: tc.TileLevel


class InvTileOp(NamedTuple):
    coarse: tc.TileLevel
    fine: tc.TileLevel


class SpConv(nn.Module):
    """One sparse conv layer: params (taps, Cin, Cout) + bias, applied
    through whichever engine the op descriptor selects."""
    features: int
    taps: int  # kernel volume
    dtype: str = "bf16"   # conv compute dtype (fp32 accumulation)
    plane_apply: bool = False  # plane-grouped slice gathers (27-tap only)

    @nn.compact
    def __call__(self, feats, op, out_mask=None):
        cin = feats.shape[-1]
        cdt = jnp.bfloat16 if self.dtype == "bf16" else jnp.float32
        w = self.param("kernel", nn.initializers.he_normal(),
                       (self.taps, cin, self.features), jnp.float32)
        b = self.param("bias", nn.initializers.zeros, (self.features,),
                       jnp.float32)
        if isinstance(op, sc.ConvIndex):
            # bf16 by default like the band/pillar paths: the row gather
            # is bandwidth-bound, so f32 rows cost 2x the bytes.
            if self.plane_apply and self.taps == 27:
                # bit-equal 3x-fewer-transactions path (see
                # sparse_conv_apply_planes; (3,1,1) z-collapse excluded)
                return sc.sparse_conv_apply_planes(feats, op, w, b,
                                                   out_mask,
                                                   compute_dtype=cdt)
            return sc.sparse_conv_apply(feats, op, w, b, out_mask,
                                        compute_dtype=cdt)
        if isinstance(op, bc.BandIndex):
            return bc.band_conv_apply(feats, op, w, b, out_mask,
                                      compute_dtype=cdt)
        if isinstance(op, SubmOp):
            return tc.subm_conv(feats, op.lvl, w, b)
        if isinstance(op, DownOp):
            return tc.down_conv(feats, op.fine, op.coarse, w, b)
        if isinstance(op, DownDenseOp):
            return tc.down_to_dense(feats, op.fine, op.out_pad_shape,
                                    w, b, op.occ_out)
        if isinstance(op, DenseSubmOp):
            return tc.dense_subm_conv(feats, op.occ, w, b)
        if isinstance(op, DenseDownOp):
            return tc.dense_down_conv(feats, op.occ_out, w, b,
                                      op.kernel, op.stride, op.padding)
        if isinstance(op, InvDenseOp):
            return tc.inverse_from_dense(feats, op.fine, w, b)
        if isinstance(op, InvTileOp):
            return tc.inverse_from_tiles(feats, op.coarse, op.fine, w, b)
        raise TypeError(f"unknown conv op {type(op)}")


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid voxel rows of a (V, C) feature array, with
    running stats and optional cross-replica sync (axis_name="data")."""
    sync: bool = False
    momentum: float = 0.99
    eps: float = 1e-3

    @nn.compact
    def __call__(self, x, mask, train: bool):
        C = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (C,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (C,), jnp.float32)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((C,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((C,), jnp.float32))
        if train:
            m = mask[:, None].astype(jnp.float32)
            n = jnp.sum(m) + 1e-6
            s1 = jnp.sum(x * m, axis=0)
            s2 = jnp.sum(x * x * m, axis=0)
            if self.sync and axis_present("data"):
                n = jax.lax.psum(n, "data")
                s1 = jax.lax.psum(s1, "data")
                s2 = jax.lax.psum(s2, "data")
            mean = s1 / n
            var = jnp.maximum(s2 / n - mean * mean, 0.0)
            if not self.is_initializing():
                ra_mean.value = (self.momentum * ra_mean.value +
                                 (1 - self.momentum) * mean)
                ra_var.value = (self.momentum * ra_var.value +
                                (1 - self.momentum) * var)
        else:
            mean, var = ra_mean.value, ra_var.value
        y = (x - mean) * jax.lax.rsqrt(var + self.eps) * scale + bias
        return jnp.where(mask[:, None], y, 0.0)


class SparseMiddleCov(nn.Module):
    """Sparse middle net with BEV output + full-res covariance decoder."""
    cfg: MiddleCfg

    def _norm(self, x, mask, train):
        """x: (rows, C) or an N-D block/dense tensor with matching mask
        shape; stats are over the masked rows either way."""
        if x.ndim > 2:
            shp = x.shape
            y = self._norm(x.reshape(-1, shp[-1]), mask.reshape(-1),
                           train)
            return y.reshape(shp)
        if self.cfg.bn_type == "none":
            return x
        return MaskedBatchNorm(sync=self.cfg.bn_type == "sync_bn")(
            x, mask, train)

    @nn.compact
    def __call__(self, voxel_features: jax.Array, geo, train: bool):
        """voxel_features: (V0, F) encoded per-voxel features aligned
        with the frame's voxel stream.  geo: FrameGeometry (rulebook
        engine) or TiledGeometry (tiled engine).  Returns
        (bev (H, W, C*D), cov_params (V0, 7))."""
        if isinstance(geo, tc.TiledGeometry):
            return self._run(voxel_features, _TiledPlan(geo), train)
        return self._run(voxel_features, _RulebookPlan(geo), train)

    def _run(self, voxel_features, plan, train):
        c0, c1, c2, c3 = self.cfg.channels
        relu = nn.relu
        cdt = self.cfg.conv_dtype

        def conv(feats, taps):
            return SpConv(feats, taps, cdt,
                          plane_apply=self.cfg.plane_apply)

        def block(x, lvl_i, feats, n_layers, train):
            for _ in range(n_layers):
                x = conv(feats, 27)(x, plan.subm(lvl_i),
                                    plan.mask(lvl_i))
                x = self._norm(x, plan.mask(lvl_i), train)
                x = relu(x)
            return x

        x = plan.inject(voxel_features)
        # encoder (middle_conv): L0 subm x2 -> down -> L1 subm x2 -> down
        x = block(x, 0, c0, 2, train)
        x = conv(c1, 27)(x, plan.down(0), plan.mask(1))
        x = relu(self._norm(x, plan.mask(1), train))
        x = block(x, 1, c1, 2, train)
        x = conv(c2, 27)(x, plan.down(1), plan.mask(2))
        x = relu(self._norm(x, plan.mask(2), train))
        x_mid = x  # L2 features feed the covariance decoder

        # tail: L2 subm x3 -> down -> L3 subm x3 -> z-collapse to L4
        x = block(x, 2, c2, 3, train)
        x = conv(c3, 27)(x, plan.down(2), plan.mask(3))
        x = relu(self._norm(x, plan.mask(3), train))
        x = block(x, 3, c3, 3, train)
        x = conv(c3, 3)(x, plan.down(3), plan.mask(4))
        x = relu(self._norm(x, plan.mask(4), train))

        bev = plan.to_bev(x)

        # covariance decoder: inverse convs back to full res (always BN,
        # mirroring the reference's plain BatchNorm1d in the decoder)
        bn = lambda: MaskedBatchNorm(sync=False)
        y = conv(c1, 27)(x_mid, plan.inv(0), plan.mask(1))
        y = relu(self._bn_apply(bn(), y, plan, 1, train))
        y = conv(c1, 27)(y, plan.subm(1), plan.mask(1))
        y = relu(self._bn_apply(bn(), y, plan, 1, train))
        y = conv(c0, 27)(y, plan.inv(1), plan.mask(0))
        y = relu(self._bn_apply(bn(), y, plan, 0, train))
        y = conv(c0, 27)(y, plan.subm(0), plan.mask(0))
        y = relu(self._bn_apply(bn(), y, plan, 0, train))
        y = conv(c0, 27)(y, plan.subm(0), plan.mask(0))
        y = relu(self._bn_apply(bn(), y, plan, 0, train))
        cov = conv(self.cfg.cov_channels, 27)(y, plan.subm(0),
                                              plan.mask(0))
        cov = plan.extract_rows(cov)
        cov = jnp.concatenate(
            [nn.elu(cov[:, :3]) + 1 + 1e-6, cov[:, 3:]], axis=-1)
        cov = jnp.where(plan.row_mask()[:, None], cov, 0.0)
        return bev, cov

    @staticmethod
    def _bn_apply(mod, x, plan, lvl_i, train):
        if x.ndim > 2:
            shp = x.shape
            return mod(x.reshape(-1, shp[-1]),
                       plan.mask(lvl_i).reshape(-1),
                       train).reshape(shp)
        return mod(x, plan.mask(lvl_i), train)


class _RulebookPlan:
    """Op/mask provider for the sorted-level rulebook engine."""

    def __init__(self, geo: FrameGeometry):
        self.geo = geo

    def inject(self, rows):
        return rows

    def subm(self, i):
        return self.geo.sub_rb[i]

    def down(self, i):
        return self.geo.down_rb[i]

    def inv(self, i):
        return self.geo.inv_rb[i]

    def mask(self, i):
        return self.geo.levels[i].mask

    def row_mask(self):
        return self.geo.levels[0].mask

    def extract_rows(self, cov):
        return cov

    def to_bev(self, x):
        dense = sc.to_dense(x, self.geo.levels[4])
        nz, ny, nx, C = dense.shape
        return jnp.transpose(dense, (1, 2, 0, 3)).reshape(ny, nx, nz * C)


class _TiledPlan:
    """Op/mask provider for the tiled dense engine.  Levels 0-1 are
    tile blocks, levels 2-4 dense grids; masks follow the data layout."""

    def __init__(self, geo: tc.TiledGeometry):
        self.geo = geo
        l1 = geo.l1
        self._pad2 = tuple(l1.tgrid[d] * l1.half[d] for d in range(3))

    def inject(self, rows):
        return tc.scatter_voxels(rows, self.geo.cell_index, self.geo.l0)

    def subm(self, i):
        if i <= 1:
            return SubmOp((self.geo.l0, self.geo.l1)[i])
        return DenseSubmOp((self.geo.occ2, self.geo.occ3)[i - 2])

    def down(self, i):
        g = self.geo
        if i == 0:
            return DownOp(g.l0, g.l1)
        if i == 1:
            return DownDenseOp(g.l1, self._pad2, g.occ2)
        if i == 2:
            return DenseDownOp(g.occ3, (3, 3, 3), (2, 2, 2), (0, 1, 1))
        return DenseDownOp(g.occ4, (3, 1, 1), (2, 1, 1), (0, 0, 0))

    def inv(self, i):
        if i == 0:
            return InvDenseOp(self.geo.l1)       # dense L2 -> tiled L1
        return InvTileOp(self.geo.l1, self.geo.l0)

    def mask(self, i):
        g = self.geo
        if i <= 1:
            return (g.l0, g.l1)[i].occ
        return (g.occ2, g.occ3, g.occ4)[i - 2]

    def row_mask(self):
        flat = self.geo.l0.occ.reshape(-1)
        flat = jnp.concatenate([flat, jnp.zeros((1,), bool)])
        return flat[self.geo.cell_index]

    def extract_rows(self, cov):
        return tc.gather_voxels(cov, self.geo.cell_index)

    def to_bev(self, x):
        # x dense (z4p, H, W, C); true z4 from occ4's shape
        z4, H, W = self.geo.occ4.shape
        d = x[:z4, :H, :W]
        return jnp.transpose(d, (1, 2, 0, 3)).reshape(H, W,
                                                      z4 * d.shape[-1])
