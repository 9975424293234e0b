"""Pose-graph optimization: Gauss-Newton on the SE(3) manifold, jitted.

Promotes the reference's latent PGO machinery
(/root/reference/rslo/utils/pose_utils.py:500-816 — chain + all-pairs
Gauss-Newton with Cholesky solves and quaternion exp-map updates) to a
first-class layer: the whole solver is one jitted function
with static problem capacities (padded edges with zero information),
Levenberg damping, and autodiff Jacobians of the manifold residual —
no hand-derived Jacobian blocks.

Design notes:
  * a refinement window holds N poses (N <= ~128): the dense 6N x 6N
    normal system is tiny; one dense Cholesky on the device beats any
    sparse scatter-gather;
  * edges are (E, 2) index pairs + (E, 7) measurements + (E, 6, 6)
    information matrices — uncertainty from the network's covariance
    head plugs in directly;
  * fixed iteration count (lax.fori_loop), masked validity, no host
    round-trips.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import (compose_pose, invert_pose, qexp, qlog, qmult,
                        qnormalize)

HI = jax.lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    """Static-capacity pose-graph problem.

    edges:    (E, 2) int32 (i, j) pose indices.
    meas:     (E, 7) measured relative pose of j in i's frame.
    info:     (E, 6, 6) information matrices (zero rows disable an edge).
    anchors:  (N,) bool — poses held fixed (at least one must be True).
    """
    edges: jax.Array
    meas: jax.Array
    info: jax.Array
    anchors: jax.Array


def edge_residual(pose_i: jax.Array, pose_j: jax.Array,
                  z: jax.Array) -> jax.Array:
    """6-dim manifold residual of one edge: log(z^-1 * (Ti^-1 Tj))."""
    rel = compose_pose(invert_pose(pose_i), pose_j)
    err = compose_pose(invert_pose(z), rel)
    return jnp.concatenate([err[..., :3], 2.0 * qlog(err[..., 3:])],
                           axis=-1)


def _retract(poses: jax.Array, delta: jax.Array) -> jax.Array:
    """Apply local updates delta (N, 6) to poses (N, 7)."""
    t = poses[:, :3] + delta[:, :3]
    dq = qexp(0.5 * delta[:, 3:])
    q = qnormalize(qmult(poses[:, 3:], dq))
    return jnp.concatenate([t, q], axis=-1)


def _residuals(delta: jax.Array, poses: jax.Array, graph: PoseGraph):
    p = _retract(poses, delta)
    pi = p[graph.edges[:, 0]]
    pj = p[graph.edges[:, 1]]
    return edge_residual(pi, pj, graph.meas)      # (E, 6)


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(poses_init: jax.Array, graph: PoseGraph,
                        iters: int = 10, damping: float = 1e-6):
    """Gauss-Newton with Levenberg damping.  Returns (poses, final_cost).

    poses_init: (N, 7).  Anchored poses keep their initial value (their
    6x6 block is replaced by identity and their residual gradient
    zeroed, the standard gauge fix).
    """
    N = poses_init.shape[0]
    anchors6 = jnp.repeat(graph.anchors, 6)

    def gn_step(_, carry):
        poses, _prev_cost = carry
        delta0 = jnp.zeros((N, 6), poses.dtype)
        r = _residuals(delta0, poses, graph)       # (E, 6)
        J = jax.jacfwd(lambda d: _residuals(d, poses, graph))(delta0)
        E = r.shape[0]
        J = J.reshape(E * 6, N * 6)
        # weight by information: Lambda r and Lambda J row-blocks
        Lam = graph.info                           # (E, 6, 6)
        r_w = jnp.einsum('eab,eb->ea', Lam, r, precision=HI).reshape(-1)
        J_w = jnp.einsum('eab,ebn->ean', Lam,
                         J.reshape(E, 6, N * 6), precision=HI
                         ).reshape(E * 6, N * 6)
        H = jnp.dot(J.T, J_w, preferred_element_type=jnp.float32,
                    precision=HI)
        g = jnp.dot(J.T, r_w, preferred_element_type=jnp.float32,
                    precision=HI)
        # gauge fix: anchored blocks -> identity rows/cols, zero gradient
        free = ~anchors6
        H = jnp.where(free[:, None] & free[None, :], H, 0.0)
        H = H + jnp.diag(jnp.where(free, damping, 1.0))
        g = jnp.where(free, g, 0.0)
        L = jax.scipy.linalg.cho_factor(
            H + 1e-9 * jnp.eye(N * 6, dtype=H.dtype))
        step = -jax.scipy.linalg.cho_solve(L, g)
        new_poses = _retract(poses, step.reshape(N, 6))
        new_r = _residuals(jnp.zeros((N, 6)), new_poses, graph)
        new_cost = jnp.einsum('ea,eab,eb->', new_r, Lam, new_r,
                              precision=HI)
        return (new_poses, new_cost)

    r0 = _residuals(jnp.zeros((N, 6)), poses_init, graph)
    cost0 = jnp.einsum('ea,eab,eb->', r0, graph.info, r0, precision=HI)
    poses, cost = jax.lax.fori_loop(0, iters, gn_step,
                                    (poses_init, cost0))
    return poses, cost


def chain_graph(odoms: jax.Array, info_scale: float = 1.0,
                loop_edges: jax.Array | None = None,
                loop_meas: jax.Array | None = None,
                loop_info: jax.Array | None = None) -> tuple:
    """Build a chain pose graph from sequential odometry.

    odoms: (N-1, 7) relative motions (frame k -> k+1 expressed in k).
    Optional loop-closure edges append to the chain.  Returns
    (poses_init (N, 7), PoseGraph)."""
    from ..geometry import odom_to_abs_pose
    import numpy as np
    n = len(odoms) + 1
    ident = jnp.concatenate([jnp.zeros((1, 3)),
                             jnp.array([[1.0, 0, 0, 0]])], axis=-1)
    odoms_full = jnp.concatenate([ident, odoms], axis=0)
    poses0 = jnp.asarray(odom_to_abs_pose(np.asarray(odoms_full)))
    edges = jnp.stack([jnp.arange(n - 1), jnp.arange(1, n)], axis=-1)
    meas = odoms
    info = jnp.tile(jnp.eye(6)[None] * info_scale, (n - 1, 1, 1))
    if loop_edges is not None:
        edges = jnp.concatenate([edges, loop_edges])
        meas = jnp.concatenate([meas, loop_meas])
        info = jnp.concatenate([info, loop_info])
    anchors = jnp.zeros((n,), bool).at[0].set(True)
    return poses0, PoseGraph(edges.astype(jnp.int32), meas, info, anchors)
