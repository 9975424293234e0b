"""Quaternion and rigid-pose algebra for the odometry stack.

Conventions (matching the reference framework's semantics, see
/root/reference/rslo/utils/pose_utils.py:48-200):

* Quaternions are stored **wxyz** (scalar first).
* A pose is a 7-vector ``[t(3), q(4)]``: translation then unit quaternion.
* ``compose(p1, p2)`` applies ``p2`` first, then ``p1``:
  ``T(p1 ∘ p2) x = T(p1) T(p2) x``.
* Predicted quaternions are canonicalized to the ``q_w >= 0`` hemisphere
  where noted (``hemisphere``).

Everything here is pure ``jax.numpy`` on the trailing axis so it works
batched, jitted, vmapped, and inside ``lax`` loops.  All functions accept
arrays of shape ``(..., D)``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-12


def safe_norm(x: jax.Array, axis=-1, keepdims=True,
              eps: float = EPS) -> jax.Array:
    """sqrt(sum(x^2) + eps^2): finite gradient at x == 0 (a plain
    jnp.linalg.norm has d(sqrt)/dx = inf at 0, which turns masked-out
    padding into NaN grads via 0 * inf)."""
    return jnp.sqrt(jnp.sum(x * x, axis=axis, keepdims=keepdims) +
                    eps * eps)


def qnormalize(q: jax.Array, eps: float = EPS) -> jax.Array:
    """Normalize quaternion(s) to unit norm along the last axis."""
    return q / safe_norm(q, eps=1e-8)


def hemisphere(q: jax.Array) -> jax.Array:
    """Flip quaternion(s) onto the q_w >= 0 hemisphere.

    Matches the reference's ``q *= sign(q[..., 0:1])`` with the convention
    that an exactly-zero scalar part keeps the sign (sign(0) -> treat as +1
    so we never zero out a quaternion).
    """
    s = jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q * s


def qmult(q1: jax.Array, q2: jax.Array, normalize: bool = True) -> jax.Array:
    """Hamilton product ``q1 * q2`` (wxyz).  Optionally re-normalized,
    mirroring the reference which always renormalizes after multiplying."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - jnp.sum(v1 * v2, axis=-1, keepdims=True)
    v = w2 * v1 + w1 * v2 + jnp.cross(v1, v2)
    q = jnp.concatenate([w, v], axis=-1)
    return qnormalize(q) if normalize else q


def qinv(q: jax.Array) -> jax.Array:
    """Conjugate (== inverse for unit quaternions)."""
    return jnp.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def qexp(v: jax.Array) -> jax.Array:
    """Exponential map from R^3 (log-quaternion) to unit quaternion (wxyz).

    safe_norm keeps the Jacobian finite at v == 0 (the solver linearizes
    retractions at exactly zero local coordinates)."""
    n = safe_norm(v, eps=1e-8)
    return jnp.concatenate([jnp.cos(n), v * (jnp.sin(n) / n)], axis=-1)


def qlog(q: jax.Array) -> jax.Array:
    """Log map from unit quaternion (wxyz) to R^3.

    atan2 formulation — unlike acos(w), its derivative stays finite as
    the angle -> 0, which matters because the pose-graph solver
    differentiates through this at near-identity residuals."""
    v = q[..., 1:]
    w = q[..., :1]
    s = safe_norm(v, eps=1e-8)
    ang = jnp.arctan2(s, w)
    return v * (ang / s)


def rotate_vec_by_q(t: jax.Array, q: jax.Array) -> jax.Array:
    """Rotate vector(s) ``t`` by unit quaternion(s) ``q``:
    ``t' = t + 2 q_w (q_v x t) + 2 q_v x (q_v x t)``."""
    qw, qv = q[..., :1], q[..., 1:]
    b = jnp.cross(qv, t)
    c = 2.0 * jnp.cross(qv, b)
    return t + 2.0 * qw * b + c


def compose_pose(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """Compose 7-dim poses: apply ``p2`` first, then ``p1``."""
    t1, q1 = p1[..., :3], p1[..., 3:]
    t2, q2 = p2[..., :3], p2[..., 3:]
    q = qmult(q1, q2)
    t = t1 + rotate_vec_by_q(t2, q1)
    return jnp.concatenate([t, q], axis=-1)


def invert_pose(p: jax.Array) -> jax.Array:
    """Inverse of a 7-dim pose."""
    t, q = p[..., :3], p[..., 3:]
    qi = qinv(q)
    ti = -rotate_vec_by_q(t, qi)
    return jnp.concatenate([ti, qi], axis=-1)


def calc_vo(p0: jax.Array, p1: jax.Array) -> jax.Array:
    """Relative pose of ``p1`` expressed in the ``p0`` frame."""
    return compose_pose(invert_pose(p0), p1)


def transform_points(pose: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply pose ``[t, q]`` (shape (7,) or (...,7)) to points (..., N, 3)."""
    t, q = pose[..., None, :3], pose[..., None, 3:]
    return rotate_vec_by_q(pts, jnp.broadcast_to(q, pts.shape[:-1] + (4,))) + t


# --- quaternion <-> rotation matrix -----------------------------------------

def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion (wxyz, (...,4)) -> rotation matrix (...,3,3)."""
    q = qnormalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: jax.Array) -> jax.Array:
    """Rotation matrix (...,3,3) -> unit quaternion (wxyz, (...,4)).

    Branch-free Shepperd-style selection of the numerically best of the four
    candidate extractions, safe under jit (no data-dependent control flow).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternions, each valid when its pivot is largest.
    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    qw0 = safe_sqrt(1.0 + tr)
    q0 = jnp.stack([qw0, (m21 - m12) / qw0, (m02 - m20) / qw0,
                    (m10 - m01) / qw0], axis=-1) * 0.5

    qx1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = jnp.stack([(m21 - m12) / qx1, qx1, (m01 + m10) / qx1,
                    (m02 + m20) / qx1], axis=-1) * 0.5

    qy2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = jnp.stack([(m02 - m20) / qy2, (m01 + m10) / qy2, qy2,
                    (m12 + m21) / qy2], axis=-1) * 0.5

    qz3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = jnp.stack([(m10 - m01) / qz3, (m02 + m20) / qz3,
                    (m12 + m21) / qz3, qz3], axis=-1) * 0.5

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                        -m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)  # (...,4cand,4)
    q = jnp.take_along_axis(qs, best[..., None, None].repeat(4, -1),
                            axis=-2).squeeze(-2)
    return qnormalize(q)


def slerp(q0: jax.Array, q1: jax.Array, alpha) -> jax.Array:
    """Spherical linear interpolation between unit quaternions (wxyz)."""
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    # Fall back to lerp when nearly parallel.
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    use_lerp = sin_theta < 1e-6
    w0 = jnp.where(use_lerp, 1.0 - alpha, jnp.sin((1 - alpha) * theta) /
                   jnp.where(use_lerp, 1.0, sin_theta))
    w1 = jnp.where(use_lerp, alpha, jnp.sin(alpha * theta) /
                   jnp.where(use_lerp, 1.0, sin_theta))
    return qnormalize(w0 * q0 + w1 * q1)
