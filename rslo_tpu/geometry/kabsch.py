"""Differentiable weighted Kabsch / Procrustes alignment (fp32 island).

Semantics follow the reference SVD head (/root/reference/rslo/layers/svd.py:7-64):
given correspondences ``src[i] <-> tgt[i]`` with weights ``w[i]``, return the
rigid transform ``(R, t)`` such that ``src ≈ R @ tgt + t`` — i.e. the
correction that maps the *target* onto the *source*.  Batched over the
leading axis and safe inside jit (reflection fix via sign select, no
data-dependent branching).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def weighted_kabsch(src: jax.Array, tgt: jax.Array,
                    weight: jax.Array | None = None,
                    eps: float = 1e-12) -> tuple[jax.Array, jax.Array]:
    """Weighted rigid alignment.

    Args:
      src: (B, N, 3) source points.
      tgt: (B, N, 3) target points (same correspondence order).
      weight: (B, N) non-negative weights; also acts as the validity mask
        (padded correspondences get weight 0).

    Returns:
      R: (B, 3, 3), t: (B, 3) with ``src ≈ R @ tgt + t``.
    """
    src = src.astype(jnp.float32)
    tgt = tgt.astype(jnp.float32)
    if weight is None:
        weight = jnp.ones(src.shape[:2], jnp.float32)
    w = weight.astype(jnp.float32)[..., None]  # (B, N, 1)
    wsum = jnp.sum(w, axis=1, keepdims=True) + eps

    src_mean = jnp.sum(src * w, axis=1, keepdims=True) / wsum
    tgt_mean = jnp.sum(tgt * w, axis=1, keepdims=True) / wsum
    src_c = src - src_mean
    tgt_c = tgt - tgt_mean

    # Cross-covariance H = sum_i w_i src_c[i] tgt_c[i]^T  -> (B, 3, 3).
    # precision=highest: this is an fp32 island — a reduced-precision
    # default (bf16 passes, or TF32 on the GPU) costs ~1e-3 rotation
    # error.
    H = jnp.einsum('bni,bnj->bij', src_c * w, tgt_c,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)

    U, _, Vh = jnp.linalg.svd(H)
    V = jnp.swapaxes(Vh, -1, -2)
    # Rotation tgt->src in the "forward" sense: R0 = V @ U^T with
    # reflection fix so det(R0) = +1.
    det = jnp.linalg.det(jnp.matmul(V, jnp.swapaxes(U, -1, -2),
                                    precision=jax.lax.Precision.HIGHEST))
    flip = jnp.stack([jnp.ones_like(det), jnp.ones_like(det),
                      jnp.sign(det)], axis=-1)  # (B, 3)
    V = V * flip[..., None, :]
    hi = jax.lax.Precision.HIGHEST
    R0 = jnp.matmul(V, jnp.swapaxes(U, -1, -2), precision=hi)
    t0 = tgt_mean.squeeze(1) - jnp.einsum('bij,bj->bi', R0,
                                          src_mean.squeeze(1), precision=hi)
    # Invert to get the tgt -> src correction (reference convention).
    R = jnp.swapaxes(R0, -1, -2)
    t = -jnp.einsum('bij,bj->bi', R, t0, precision=hi)
    return R, t
