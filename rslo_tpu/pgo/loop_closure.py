"""Loop-closure detection + edge measurement for the refinement layer.

A capability the reference only gestures at (its ``refine`` flag is
dead — /root/reference/evaluate.py:39,167): close trajectory loops and
feed them to the pose-graph solver.  Design:

  * place recognition = a Scan-Context-style polar BEV descriptor
    (ring x sector max-height signature).  Rotation invariance is a
    maximum over circular sector shifts, evaluated as ONE batched
    matmul of the S shifted query signatures against the database —
    an (S, R*S) @ (R*S, K) matmul, not a host loop;
  * a cheap rotation-invariant ring key (per-ring occupancy mean)
    prefilters candidates with an (N, N) distance matrix;
  * each detected loop edge is measured by a fixed-iteration
    point-to-point ICP (chamfer NN association + weighted Kabsch)
    seeded with the descriptor's yaw estimate, entirely inside one
    jit (``lax.fori_loop``, static shapes);
  * the edges drop into ``pose_graph.chain_graph`` /
    ``optimize_pose_graph`` (jitted manifold Gauss-Newton).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import matrix_to_quat, rotate_vec_by_q, weighted_kabsch
from ..ops.chamfer import nn_search

HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Descriptor


@functools.partial(jax.jit, static_argnames=("n_rings", "n_sectors"))
def polar_descriptor(points: jax.Array, mask: jax.Array,
                     n_rings: int = 20, n_sectors: int = 60,
                     max_radius: float = 70.0,
                     z_offset: float = 2.0) -> jax.Array:
    """(N, >=3) masked points -> (R, S) max-height polar signature.

    Cells with no points are 0; heights are offset so ground (~-z_offset)
    maps near 0 and structure rises above it."""
    xy = points[:, :2].astype(jnp.float32)
    r = jnp.sqrt(jnp.sum(xy * xy, axis=-1) + 1e-12)
    theta = jnp.arctan2(xy[:, 1], xy[:, 0])
    ring = jnp.clip((r / max_radius * n_rings).astype(jnp.int32),
                    0, n_rings - 1)
    sector = (((theta + jnp.pi) / (2 * jnp.pi) * n_sectors)
              .astype(jnp.int32)) % n_sectors
    z = points[:, 2].astype(jnp.float32) + z_offset
    valid = mask & (r < max_radius)
    flat = jnp.where(valid, ring * n_sectors + sector,
                     n_rings * n_sectors)
    sig = jnp.zeros(n_rings * n_sectors + 1, jnp.float32)
    sig = sig.at[flat].max(jnp.where(valid, jnp.maximum(z, 1e-3), 0.0),
                           mode="drop")
    return sig[:-1].reshape(n_rings, n_sectors)


def ring_key(desc: jax.Array) -> jax.Array:
    """(..., R, S) -> (..., R) rotation-invariant per-ring mean."""
    return jnp.mean(desc, axis=-1)


@jax.jit
def shift_similarity(query: jax.Array, database: jax.Array):
    """Rotation-searched cosine similarity.

    query: (R, S); database: (K, R, S).
    Returns (scores (K,), shifts (K,)): the best circular sector shift
    of the query against each database entry.  The S shifted copies of
    the query form an (S, R*S) matrix multiplied against (K, R*S)^T —
    one matmul instead of a shift loop."""
    S = query.shape[-1]
    shifted = jax.vmap(lambda s: jnp.roll(query, s, axis=-1))(
        jnp.arange(S))                              # (S, R, S)
    qn = jnp.sqrt(jnp.sum(query * query) + 1e-12)
    dn = jnp.sqrt(jnp.sum(database * database, axis=(1, 2)) + 1e-12)
    scores = jnp.einsum("srk,nrk->ns", shifted, database,
                        precision=HI) / (qn * dn[:, None])   # (K, S)
    return scores.max(axis=-1), scores.argmax(axis=-1)


def shift_to_yaw(shift: jax.Array, n_sectors: int) -> jax.Array:
    """Sector shift -> yaw angle (radians) rotating the candidate frame
    into the query frame about +z.  Shifts > S/2 wrap negative."""
    s = jnp.where(shift > n_sectors // 2, shift - n_sectors, shift)
    return -2.0 * jnp.pi * s / n_sectors


def yaw_pose(yaw: jax.Array) -> jax.Array:
    """(…,) yaw -> (…, 7) pose [0, 0, 0, qw, 0, 0, qz]."""
    half = 0.5 * yaw
    zeros = jnp.zeros_like(yaw)
    return jnp.stack([zeros, zeros, zeros, jnp.cos(half),
                      zeros, zeros, jnp.sin(half)], axis=-1)


# ---------------------------------------------------------------------------
# Detection


class LoopCandidates(NamedTuple):
    pairs: np.ndarray     # (L, 2) int (i, j), j < i - min_separation
    scores: np.ndarray    # (L,) descriptor cosine similarity
    yaws: np.ndarray      # (L,) initial yaw estimate (candidate->query)


def detect_loops(descriptors: jax.Array, min_separation: int = 50,
                 score_threshold: float = 0.8,
                 ring_top_k: int = 5) -> LoopCandidates:
    """All-pairs loop detection over a trajectory's descriptors.

    descriptors: (N, R, S).  For each frame i, the ring-key (N, N)
    distance matrix prefilters the ``ring_top_k`` most similar earlier
    frames (j <= i - min_separation); the shifted-cosine match then
    scores them, keeping the best per i above ``score_threshold``."""
    desc = jnp.asarray(descriptors)
    N = desc.shape[0]
    if N <= min_separation:
        return LoopCandidates(np.zeros((0, 2), np.int32),
                              np.zeros((0,), np.float32),
                              np.zeros((0,), np.float32))
    keys = ring_key(desc)                                   # (N, R)
    d2 = (jnp.sum(keys ** 2, -1)[:, None]
          + jnp.sum(keys ** 2, -1)[None, :]
          - 2.0 * jnp.dot(keys, keys.T, precision=HI))      # (N, N)
    ii = jnp.arange(N)
    allowed = (ii[None, :] <= ii[:, None] - min_separation)
    d2 = jnp.where(allowed, d2, jnp.inf)
    k = min(ring_top_k, N)
    cand = jnp.argsort(d2, axis=1)[:, :k]                   # (N, k)

    def score_row(i, cands):
        sc, sh = shift_similarity(desc[i], desc[cands])
        sc = jnp.where(jnp.isfinite(d2[i, cands]), sc, -1.0)
        b = jnp.argmax(sc)
        return sc[b], cands[b], sh[b]

    scores, best_j, shifts = jax.vmap(score_row)(ii, cand)
    scores = np.asarray(scores)
    best_j = np.asarray(best_j)
    yaws = np.asarray(shift_to_yaw(shifts, desc.shape[-1]))
    keep = scores >= score_threshold
    idx = np.nonzero(keep)[0]
    pairs = np.stack([idx, best_j[idx]], axis=-1).astype(np.int32)
    return LoopCandidates(pairs, scores[idx], yaws[idx])


# ---------------------------------------------------------------------------
# Edge measurement (point-to-point ICP)


@functools.partial(jax.jit, static_argnames=("iters",))
def icp_align(pts_i: jax.Array, mask_i: jax.Array,
              pts_j: jax.Array, mask_j: jax.Array,
              init_pose: jax.Array, iters: int = 8,
              gate: float = 2.0):
    """Align cloud j onto cloud i: returns (pose T_{i<-j}, mean residual,
    inlier fraction) with ``p_i ≈ R(T) p_j + t(T)``.

    Fixed-iteration ICP: transform j by the current pose, associate to
    the nearest i point (chamfer scan), gate by ``gate`` metres, and
    re-solve the full alignment with weighted Kabsch each iteration."""
    pi = pts_i[:, :3].astype(jnp.float32)
    pj = pts_j[:, :3].astype(jnp.float32)

    def body(_, carry):
        pose, _res, _frac = carry
        moved = rotate_vec_by_q(pj, pose[3:]) + pose[:3]
        d2, idx = nn_search(moved, mask_j, pi, mask_i)
        w = (mask_j & (d2 < gate * gate)).astype(jnp.float32)
        src = pi[idx]                      # matched i points
        R, t = weighted_kabsch(src[None], pj[None], w[None])
        q = matrix_to_quat(R[0])
        new_pose = jnp.concatenate([t[0], q])
        res = jnp.sqrt(jnp.sum(d2 * w) / jnp.maximum(w.sum(), 1.0))
        frac = w.sum() / jnp.maximum(mask_j.sum(), 1.0)
        return (new_pose, res, frac)

    return jax.lax.fori_loop(0, iters, body,
                             (init_pose.astype(jnp.float32),
                              jnp.asarray(0.0), jnp.asarray(0.0)))


# ---------------------------------------------------------------------------
# Driver


def close_loops(odoms: np.ndarray, clouds, masks=None,
                min_separation: int = 50, score_threshold: float = 0.8,
                icp_iters: int = 8, gate: float = 2.0,
                min_inlier_frac: float = 0.3,
                odom_info: float = 1.0, loop_info: float = 10.0,
                gn_iters: int = 15):
    """Full loop-closing pass over a trajectory.

    odoms: (N-1, 7) sequential relative motions; clouds: length-N
    sequence of (P, >=3) scans (fixed P; pad + mask).  Returns
    (poses (N, 7) optimized absolute trajectory, LoopCandidates kept).
    """
    from .pose_graph import chain_graph, optimize_pose_graph

    N = len(clouds)
    if masks is None:
        masks = [np.ones(len(c), bool) for c in clouds]
    desc = jnp.stack([
        polar_descriptor(jnp.asarray(c), jnp.asarray(m))
        for c, m in zip(clouds, masks)])
    cands = detect_loops(desc, min_separation, score_threshold)
    edges, meas, infos = [], [], []
    for (i, j), yaw in zip(cands.pairs, cands.yaws):
        # i is the later (query) frame, j the revisited earlier one.
        pose_ij, res, frac = icp_align(
            jnp.asarray(clouds[i]), jnp.asarray(masks[i]),
            jnp.asarray(clouds[j]), jnp.asarray(masks[j]),
            yaw_pose(jnp.asarray(yaw)), iters=icp_iters, gate=gate)
        if float(frac) < min_inlier_frac:
            continue
        # icp gives T_{i<-j} (j's points into i's frame) — exactly the
        # solver's "pose of j in i's frame" measurement for edge (i, j).
        edges.append((int(i), int(j)))
        meas.append(np.asarray(pose_ij, np.float32))
        w = loop_info / (1.0 + float(res))
        infos.append(np.eye(6, dtype=np.float32) * w)
    if edges:
        le = jnp.asarray(edges, jnp.int32)
        lm = jnp.asarray(np.stack(meas))
        li = jnp.asarray(np.stack(infos))
        poses0, graph = chain_graph(jnp.asarray(odoms), odom_info,
                                    loop_edges=le, loop_meas=lm,
                                    loop_info=li)
    else:
        poses0, graph = chain_graph(jnp.asarray(odoms), odom_info)
    poses, _cost = optimize_pose_graph(poses0, graph, iters=gn_iters)
    return np.asarray(poses), cands
