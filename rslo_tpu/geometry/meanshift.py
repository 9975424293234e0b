"""Batched mean-shift clustering (fixed iterations, jit-safe).

Counterpart of the reference's GPU mean-shift
(/root/reference/rslo/utils/geometric.py:24-156, unused by its main
train/eval path): Gaussian-kernel mode seeking over a point set,
optionally confidence-weighted, with Euclidean or cosine distances.
All-pairs kernels are matmuls; the loop is a
``lax.fori_loop`` with static shapes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

HI = jax.lax.Precision.HIGHEST


def _pairwise_sq(a: jax.Array, b: jax.Array) -> jax.Array:
    """a: (N, K), b: (M, K) -> (N, M) squared Euclidean distances."""
    aa = jnp.sum(a * a, -1)[:, None]
    bb = jnp.sum(b * b, -1)[None, :]
    return jnp.maximum(aa + bb - 2.0 * jnp.dot(a, b.T, precision=HI), 0.0)


def _cosine_dist(a: jax.Array, b: jax.Array, eps=1e-12) -> jax.Array:
    an = a / jnp.sqrt(jnp.sum(a * a, -1, keepdims=True) + eps)
    bn = b / jnp.sqrt(jnp.sum(b * b, -1, keepdims=True) + eps)
    return 1.0 - jnp.dot(an, bn.T, precision=HI)


@functools.partial(jax.jit,
                   static_argnames=("iters", "dist_type"))
def mean_shift(points: jax.Array, conf: jax.Array | None = None,
               bandwidth: float = 2.5, iters: int = 5,
               dist_type: str = "euclidean") -> jax.Array:
    """Shift every point to its local density mode.

    points: (N, K); conf: optional (N,) sample weights.
    Returns modes (N, K)."""
    x = points.astype(jnp.float32)
    w = (jnp.ones(x.shape[0], jnp.float32) if conf is None
         else conf.astype(jnp.float32))

    def body(_, y):
        if dist_type == "cosine":
            d2 = _cosine_dist(y, x) ** 2
        else:
            d2 = _pairwise_sq(y, x)
        k = jnp.exp(-0.5 * d2 / (bandwidth * bandwidth)) * w[None, :]
        num = jnp.dot(k, x, precision=HI)
        den = jnp.sum(k, -1, keepdims=True)
        return num / jnp.maximum(den, 1e-12)

    return jax.lax.fori_loop(0, iters, body, x)


@jax.jit
def label_modes(modes: jax.Array, tol: float = 1e-1) -> jax.Array:
    """Cluster labels from converged modes: each point's label is the
    smallest point index whose mode lies within ``tol``.  (N,) int32."""
    d2 = _pairwise_sq(modes, modes)
    close = d2 <= tol * tol                        # (N, N)
    N = modes.shape[0]
    idx = jnp.arange(N)
    return jnp.min(jnp.where(close, idx[None, :], N), axis=1)


def mean_shift_cluster(points, conf=None, bandwidth=2.5, iters=5,
                       tol=1e-1, dist_type="euclidean"):
    """Convenience: (modes, labels)."""
    m = mean_shift(points, conf, bandwidth=bandwidth, iters=iters,
                   dist_type=dist_type)
    return m, label_modes(m, tol)
