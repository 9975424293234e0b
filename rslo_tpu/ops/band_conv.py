"""Banded sparse-conv engine — contiguous windows + one-hot matmuls.

The rulebook engine (:mod:`rslo_tpu.ops.sparse_conv`) gathers one
feature row per (out row, tap) pair: ``features[rulebook.idx]``.  This
engine replaces that row gather with dense work by exploiting the
*sortedness invariant* of sparse levels: both the out sites and the in
sites of every rulebook are sorted by linearized voxel id, and each
kernel tap adds a constant id offset — so per tap the map ``out row ->
in row`` is monotone, and the in rows needed by a *block* of B
consecutive out rows live in a narrow contiguous window.  That turns the
gather into

  1. one contiguous window slice per (block, tap), and
  2. a (B, W) x (W, C) one-hot matmul per (block, tap) that selects the
     rows.

The plan stores only the per-row window offsets ``sel`` (nB, K, B)
int32; the one-hot selection matrices are built transiently by XLA.
Plans depend only on the frame geometry, so they are built once per
frame (``build_band_index``) and shared by every conv layer using the
same rulebook — the same reuse pattern as spconv's ``indice_key``
(reference /root/reference/rslo/models/middle.py:80-245).  Rows whose
window assignment overflows W (rare, data-dependent) are routed through
a small compacted overflow pair list applied with a plain scatter-add,
so the result is exact for any input.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import pytree

from .sparse_conv import ConvIndex


@pytree.dataclass
class BandIndex:
    """Banded gather plan for one rulebook (built once per frame).

    base:    (nB, K) int32 window starts into the in level's rows,
             clamped to [0, Vp_in - W].
    sel:     (nB, K, B) int32 in-window offsets (idx - base), -1 for
             invalid / out-of-window taps.
    ov_out:  (OV,) int32 overflow out row (sentinel Vp_out = dropped).
    ov_in:   (OV,) int32 overflow in row.
    ov_tap:  (OV,) int32 overflow tap.
    v_out:   static true number of out rows.
    v_in:    static padded in-row count the bases were clamped against.
    window:  static window width W.
    """
    base: jax.Array
    sel: jax.Array
    ov_out: jax.Array
    ov_in: jax.Array
    ov_tap: jax.Array
    v_out: int = pytree.static_field()
    v_in: int = pytree.static_field()
    window: int = pytree.static_field()
    # ov_count: () int32 TOTAL number of valid-but-out-of-window pairs.
    # The plan stores at most ov_out.shape[0] of them; if ov_count
    # exceeds that capacity the conv is inexact (pairs silently
    # dropped), so the counter is the runtime guard for the documented-
    # inexact path.  See overflow_saturated().
    ov_count: jax.Array | None = None

    @property
    def ov_capacity(self) -> int:
        return self.ov_out.shape[0]


def overflow_saturated(band: BandIndex) -> jax.Array:
    """() bool — True iff overflow pairs were DROPPED (plan inexact)."""
    if band.ov_count is None:  # legacy plan without the counter
        return jnp.asarray(False)
    return band.ov_count > band.ov_capacity


def build_band_index(rulebook: ConvIndex, v_in: int, block: int = 256,
                     window: int = 384,
                     ov_capacity: int = 4096) -> BandIndex:
    """Convert a rulebook into a banded gather plan.

    v_in: in level's row capacity; window slices are clamped to
    [0, max(v_in, window) - window] (callers pad features to at least
    ``window`` rows via :func:`band_conv_apply`).
    """
    V, K = rulebook.idx.shape
    B = min(block, V)
    nB = -(-V // B)
    Vp = nB * B
    Wd = min(window, max(v_in, window))
    # pad the in-row count to a multiple of 16 and floor-align the
    # window starts to 16 rows (aligned slices; the clamp bound
    # vp_in - Wd stays aligned when Wd is a multiple of 16)
    vp_in = -(-max(v_in, Wd) // 16) * 16

    idx = jnp.concatenate(
        [rulebook.idx,
         jnp.zeros((Vp - V, K), rulebook.idx.dtype)], axis=0)
    valid = jnp.concatenate(
        [rulebook.valid, jnp.zeros((Vp - V, K), bool)], axis=0)

    idx_b = idx.reshape(nB, B, K)
    val_b = valid.reshape(nB, B, K)
    big = jnp.iinfo(jnp.int32).max
    base = jnp.min(jnp.where(val_b, idx_b, big), axis=1)      # (nB, K)
    base = jnp.where(base == big, 0, base)
    base = (base // 16) * 16
    base = jnp.clip(base, 0, vp_in - Wd).astype(jnp.int32)

    delta = idx_b - base[:, None, :]                          # (nB, B, K)
    in_win = val_b & (delta >= 0) & (delta < Wd)
    sel = jnp.where(in_win, delta, -1).astype(jnp.int32)
    sel = jnp.transpose(sel, (0, 2, 1))                       # (nB, K, B)

    # Overflow pairs (valid but outside the window), compacted by rank.
    # Formulated as cumsum + a 4096-query binary search instead of
    # rank-scatter compaction: the previous three (Vp*K ~ 1.1M)-update
    # scatters into a (cap+1,) array dominated the plan-build cost.
    # searchsorted(cum, r+1) returns the flat index of the (r+1)-th set
    # flag, and past ov_count it returns len(cum) == Vp*K, which decodes
    # to the ov_out == Vp drop sentinel for free.  method='scan' is the
    # binary search (cheap at 4096 queries; 'sort' would sort the 1.1M
    # keys).
    ov_flag = (valid & ~in_win.reshape(Vp, K)).reshape(-1)
    ov_count = jnp.sum(ov_flag).astype(jnp.int32)

    def _extract(flag):
        cum = jnp.cumsum(flag.astype(jnp.int32))
        return jnp.searchsorted(
            cum, jnp.arange(1, ov_capacity + 1, dtype=jnp.int32),
            method="scan").astype(jnp.int32)

    # at the deployed windows ov_count is 0 (asserted by the deployed-
    # shape overflow test), so skip the extraction entirely then
    packed = jax.lax.cond(
        ov_count > 0, _extract,
        lambda _: jnp.full((ov_capacity,), Vp * K, jnp.int32), ov_flag)
    ov_out = packed // K
    ov_tap = packed % K
    ov_in = idx.reshape(-1)[jnp.minimum(packed, Vp * K - 1)]
    ov_in = jnp.where(ov_out < Vp, ov_in, 0)
    ov_tap = jnp.where(ov_out < Vp, ov_tap, 0)
    return BandIndex(base, sel, ov_out, ov_in, ov_tap, V, vp_in, Wd,
                     ov_count=ov_count)


# ---------------------------------------------------------------------------
# Full conv (in-window pairs + overflow pairs), XLA formulation.

def _gather_xla(f_pad: jax.Array, base: jax.Array, sel: jax.Array,
                W: int, cdt) -> jax.Array:
    """(Vp, K*Cin) gathered in-window features (zero where invalid)."""
    nB, K, B = sel.shape
    Cin = f_pad.shape[-1]
    fc = f_pad.astype(cdt)
    starts = base.reshape(-1)
    windows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(fc, (s, 0), (W, Cin)))(starts)
    windows = windows.reshape(nB, K, W, Cin)
    onehot = (sel[..., None] ==
              jnp.arange(W, dtype=jnp.int32)).astype(cdt)     # (nB,K,B,W)
    # one-hot gather: (nB,K,B,W) x (nB,K,W,Cin) -> (nB,K,B,Cin)
    g = jax.lax.dot_general(
        onehot, windows,
        dimension_numbers=(((3,), (2,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.float32)
    return jnp.transpose(g, (0, 2, 1, 3)).reshape(nB * B, K * Cin)


def _overflow_add_g(g: jax.Array, f_pad: jax.Array, ov_out, ov_in,
                    ov_tap, Vp: int, K: int, Cin: int) -> jax.Array:
    """Add overflow pairs into the gathered (Vp, K*Cin) matrix."""
    rows = jnp.where(ov_out < Vp, ov_out * K + ov_tap, Vp * K)
    g = g.reshape(Vp * K, Cin)
    g = jnp.concatenate([g, jnp.zeros((1, Cin), g.dtype)], axis=0)
    g = g.at[rows].add(f_pad[ov_in].astype(g.dtype))[:-1]
    return g.reshape(Vp, K * Cin)


def _full_xla(f_pad, w, base, sel, ov_out, ov_in, ov_tap, W: int, cdt):
    """(Vp, Cout) f32: complete banded conv in XLA."""
    nB, K, B = sel.shape
    Cin = f_pad.shape[-1]
    Cout = w.shape[-1]
    g = _gather_xla(f_pad, base, sel, W, cdt)
    g = _overflow_add_g(g, f_pad, ov_out, ov_in, ov_tap, nB * B, K, Cin)
    return jnp.dot(g.astype(cdt), w.reshape(K * Cin, Cout).astype(cdt),
                   preferred_element_type=jnp.float32)


def band_conv_apply(features: jax.Array, band: BandIndex,
                    weights: jax.Array, bias: jax.Array | None = None,
                    out_mask: jax.Array | None = None,
                    compute_dtype=jnp.bfloat16) -> jax.Array:
    """Sparse conv through the banded plan.

    features: (V_in, Cin); weights: (K, Cin, Cout).  Returns
    (v_out, Cout) float32.  Numerics: windows and one-hots run in
    ``compute_dtype`` (bf16) with fp32 accumulation — selection by a
    1.0/0.0 one-hot is exact up to the bf16 rounding of the features.
    """
    Cin = features.shape[-1]
    W = band.window

    if band.ov_count is not None and os.environ.get("RSLO_BAND_CHECK"):
        # opt-in runtime guard for the documented-inexact saturation
        # path (pairs past ov_capacity are dropped).  Env-gated: the
        # host callback would otherwise stall the device stream.
        cap = band.ov_capacity

        def _check(cnt):
            if int(cnt) > cap:
                raise RuntimeError(
                    f"band plan overflow saturated: {int(cnt)} pairs > "
                    f"capacity {cap} — the conv result is inexact; "
                    f"widen band_windows or raise ov_capacity")
        jax.debug.callback(_check, band.ov_count)

    f = features
    if f.shape[0] < band.v_in:
        f = jnp.concatenate(
            [f, jnp.zeros((band.v_in - f.shape[0], Cin), f.dtype)], 0)

    out = _full_xla(f, weights, band.base, band.sel, band.ov_out,
                    band.ov_in, band.ov_tap, W, compute_dtype)
    out = out[:band.v_out]
    if bias is not None:
        out = out + bias
    if out_mask is not None:
        out = jnp.where(out_mask[:, None], out, 0.0)
    return out


# Per-rulebook-kind window widths: the largest in-row spread of a
# 256-row block on KITTI-scale frames plus a margin (submanifold taps
# stay within ~315 rows, stride-2 taps within ~1040, inverse taps
# within ~550; the deployed-shape overflow test guards these).
SUBM_WINDOW = 384
DOWN_WINDOW = 1280
INV_WINDOW = 768


def np_oracle(features, rulebook, weights, bias=None):
    """Tiny numpy oracle for tests (dense loop over taps)."""
    idx = np.asarray(rulebook.idx)
    val = np.asarray(rulebook.valid)
    f = np.asarray(features, np.float64)
    w = np.asarray(weights, np.float64)
    V, K = idx.shape
    out = np.zeros((V, w.shape[-1]))
    for i in range(V):
        for k in range(K):
            if val[i, k]:
                out[i] += f[idx[i, k]] @ w[k]
    if bias is not None:
        out += np.asarray(bias)
    return out
