"""Self-supervised chamfer/ICP consistency loss with 3D inherent error
(covariance) modeling — the core of the self-supervision objective.

Re-design of the reference's
``Aleat5_1ChamferL2NormalWeightedALLSVDLoss``
(/root/reference/rslo/core/losses.py:301-507): one-direction NN
association, normal-cosine weighting, percentile outlier gating,
Mahalanobis residual under Σ = Σ_src + R Σ_assoc Rᵀ with a log-det
regularizer, and an inner weighted-Kabsch ICP loop whose accumulated
(res_R, res_t) correction is returned to generate pseudo ego-motion
targets.  Everything is pad+mask static-shape (dynamic point counts via
validity masks, the kth-value gate via sort + dynamic index), and the
whole pair batch is vmapped.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import quat_to_matrix, weighted_kabsch
from ..ops.chamfer import nn_search_auto as nn_search

BIG = 1e30


def span_cov(cov_params: jax.Array) -> jax.Array:
    """(N, 7) covariance params -> (N, 3, 3) SPD matrices.

    Params: cumulative non-negative eigenvalue increments (first three,
    already through elu+1 upstream) and a wxyz eigvec quaternion
    (losses.py:348-363)."""
    lam1 = cov_params[:, 0]
    lam2 = lam1 + cov_params[:, 1]
    lam3 = lam2 + cov_params[:, 2]
    q = cov_params[:, 3:]
    q = q / jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True) + 1e-18)
    V = quat_to_matrix(q)                        # (N, 3, 3)
    lam = jnp.stack([lam1, lam2, lam3], axis=-1)  # (N, 3)
    return jnp.einsum('nij,nj,nkj->nik', V, lam, V,
                      precision=jax.lax.Precision.HIGHEST)


def inv3x3(M: jax.Array, eps: float = 1e-6):
    """Closed-form batched 3x3 inverse + determinant (fp32 island).
    Regularizes by eps*I like the reference's fallback
    (losses.py:423-430)."""
    M = M + eps * jnp.eye(3, dtype=M.dtype)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    adj = jnp.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        C, -(a * h - b * g), (a * e - b * d),
    ], axis=-1).reshape(M.shape)
    return adj * inv_det[..., None, None], det


def roi_gate(dist: jax.Array, valid: jax.Array,
             penalize_ratio: float) -> jax.Array:
    """Distance-percentile outlier gate (losses.py:326-334): keep points
    with dist < max(kth-smallest distance, 1.0), where k =
    1 + floor(n_valid * ratio), computed over valid entries only."""
    N = dist.shape[0]
    d = jnp.where(valid, dist, BIG)
    ds = jnp.sort(d)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    k = 1 + (n_valid.astype(jnp.float32) * penalize_ratio).astype(jnp.int32)
    k = jnp.clip(k - 1, 0, N - 1)
    m = jnp.maximum(ds[k], 1.0)
    return (dist < m) & valid


class ConsistencyOut(NamedTuple):
    loss: jax.Array    # scalar
    res_R: jax.Array   # (3, 3) accumulated ICP correction (tgt -> src)
    res_t: jax.Array   # (3,)


def _cos_weight(normal: jax.Array, vec: jax.Array) -> jax.Array:
    num = jnp.sum(normal * vec, axis=-1)
    den = jnp.sqrt((jnp.sum(normal * normal, -1) + 1e-16) *
                   (jnp.sum(vec * vec, -1) + 1e-16))
    return jnp.abs(num / den)


def consistency_pair(src: jax.Array, src_mask: jax.Array,
                     src_normal: jax.Array, cov_src: jax.Array,
                     tgt: jax.Array, tgt_mask: jax.Array,
                     cov_tgt_spanned: jax.Array, R_pred: jax.Array,
                     *, penalize_ratio: float, reg_weight: float,
                     icp_iter: int, no_cov: bool = False) -> ConsistencyOut:
    """One frame pair.  src: (N, 3) reference-frame points; tgt: (M, 3)
    counterpart points already warped by the predicted motion; cov_src:
    (N, 7) params; cov_tgt_spanned: (M, 3, 3) already-rotated? NO —
    raw spanned covs of the warped cloud (rotation applied via R_pred in
    the Σ composition, mirroring losses.py:422)."""
    src = src.astype(jnp.float32)
    tgt = tgt.astype(jnp.float32)

    R_det = jax.lax.stop_gradient(R_pred)

    dist, idx = nn_search(src, src_mask, tgt, tgt_mask)
    assoc = tgt[idx]
    assoc_valid = tgt_mask[idx] & src_mask

    w = _cos_weight(src_normal, assoc - src)
    roi = roi_gate(dist, assoc_valid, penalize_ratio)

    diff = src - assoc
    nroi = jnp.sum(roi.astype(jnp.float32)) + 1e-12
    if no_cov:
        # hier-points fallback (voxel_odom_net.py:654): no covariances
        # from the middle net — plain squared-distance data term, no
        # log-det regularizer.
        md = jnp.sum(diff * diff, axis=-1)
        loss = jnp.sum(jnp.where(roi, md, 0.0)) / nroi
    else:
        sigma_src = span_cov(cov_src)
        sigma_assoc = cov_tgt_spanned[idx]
        sigma = sigma_src + jnp.einsum(
            'ij,njk,lk->nil', R_det, sigma_assoc, R_det,
            precision=jax.lax.Precision.HIGHEST)
        # Padded rows carry zero covariance; inverting near-zero
        # matrices explodes the backward pass (1/det^2) into
        # inf * masked-0 = NaN.  Replace invalid rows with identity
        # before inverting.
        eye = jnp.broadcast_to(jnp.eye(3, dtype=sigma.dtype), sigma.shape)
        sigma = jnp.where(assoc_valid[:, None, None], sigma, eye)
        sigma_inv, det = inv3x3(sigma)
        md = jnp.einsum('ni,nij,nj->n', diff, sigma_inv, diff,
                        precision=jax.lax.Precision.HIGHEST)
        data_term = jnp.sum(jnp.where(roi, md, 0.0)) / nroi
        logdet = 0.5 * jnp.log(jnp.maximum(det, 1e-20))
        reg_term = jnp.sum(jnp.where(roi, logdet, 0.0)) / nroi
        loss = data_term + reg_weight * reg_term

    # ---- inner ICP loop (all stop-gradient, losses.py:441-494) ----------
    src_d = jax.lax.stop_gradient(src)
    tgt_d = jax.lax.stop_gradient(tgt)
    assoc_d = jax.lax.stop_gradient(assoc)
    w_d = jax.lax.stop_gradient(w)
    roi_d = jax.lax.stop_gradient(roi)

    res_R = jnp.eye(3, dtype=jnp.float32)
    res_t = jnp.zeros((3,), jnp.float32)
    cur_assoc, cur_w, cur_roi = assoc_d, w_d, roi_d
    for it in range(icp_iter):
        kw = (cur_w ** 2) * cur_roi.astype(jnp.float32)
        R_, t_ = weighted_kabsch(src_d[None], cur_assoc[None], kw[None])
        R_, t_ = R_[0], t_[0]
        res_R = R_ @ res_R
        res_t = R_ @ res_t + t_
        if it < icp_iter - 1:
            tgt2 = tgt_d @ res_R.T + res_t
            d2, i2 = nn_search(src_d, src_mask, tgt2, tgt_mask)
            cur_assoc = tgt2[i2]
            cur_w = _cos_weight(src_normal, cur_assoc - src_d)
            cur_roi = roi_gate(d2, tgt_mask[i2] & src_mask, penalize_ratio)
    return ConsistencyOut(loss, res_R, res_t)


def consistency_loss_pairs(src, src_mask, src_normal, cov_src,
                           tgt, tgt_mask, cov_tgt, R_pred, t_pred,
                           *, penalize_ratio: float, reg_weight: float,
                           icp_iter: int):
    """Vmapped over the pair axis.

    src/tgt: (P, N, 3); masks: (P, N); cov_*: (P, N, 7) or None (the
    hier-points fallback — plain L2 data term, no regularizer);
    R_pred: (P, 3, 3); t_pred: (P, 3).  ``tgt`` must already be warped
    by (R_pred, t_pred).
    Returns (mean loss, res_R (P,3,3), res_t (P,3))."""
    no_cov = cov_src is None or cov_tgt is None
    if no_cov:
        # dummies with the right leading shapes for vmap
        cov_src = jnp.zeros(src.shape[:2] + (7,), jnp.float32)
        cov_tgt_spanned = jnp.zeros(tgt.shape[:2] + (3, 3), jnp.float32)
    else:
        cov_tgt_spanned = jax.vmap(span_cov)(cov_tgt)

    fn = functools.partial(consistency_pair, penalize_ratio=penalize_ratio,
                           reg_weight=reg_weight, icp_iter=icp_iter,
                           no_cov=no_cov)
    out = jax.vmap(fn)(src, src_mask, src_normal, cov_src,
                       tgt, tgt_mask, cov_tgt_spanned, R_pred)
    return jnp.mean(out.loss), out.res_R, out.res_t
