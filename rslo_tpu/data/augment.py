"""Host-side training augmentations.

Ports the reference's per-sample augmentations
(/root/reference/rslo/data/preprocess.py:230-245, 335-458): random y-flip
of points/normals + mirrored odometry (R' = F R F, t' = F t with
F = diag(1,-1,1)), and pose-interpolation augmentation (slerp between
window poses by a random ratio).
"""
from __future__ import annotations

import numpy as np

from ..geometry import matrix_to_quat_np, quat_to_matrix_np

FLIP = np.diag([1.0, -1.0, 1.0])


def flip_odometry(odom: np.ndarray) -> np.ndarray:
    """Mirror one (7,) pose across the xz-plane."""
    R = quat_to_matrix_np(odom[3:])
    Rn = FLIP @ R @ FLIP.T
    q = matrix_to_quat_np(Rn)
    if q[0] != 0:
        q = q * np.sign(q[0])
    return np.concatenate([FLIP @ odom[:3], q]).astype(np.float32)


def random_flip_y(sample: dict, rng: np.random.Generator) -> dict:
    """Flip point y + normal y in every frame and mirror all pair
    odometries.  Mutates and returns the sample."""
    if rng.random() <= 0.5:
        return sample
    for pts in sample["points"]:
        pts[:, 1] = -pts[:, 1]
        if pts.shape[1] >= 7:
            pts[:, 5] = -pts[:, 5]       # normal y (x,y,z,i,nx,ny,nz)
        elif pts.shape[1] >= 6:
            pts[:, 4] = -pts[:, 4]       # (x,y,z,nx,ny,nz)
    for hp in sample.get("hier_points", []):
        hp[:, 1] = -hp[:, 1]
        hp[:, 4] = -hp[:, 4]             # (x,y,z,nx,ny,nz) normal y
    odom = sample["odometry"]
    for k in range(len(odom)):
        odom[k] = flip_odometry(odom[k])
    # Mirror the absolute window poses too (T' = F T F conjugation, the
    # same map flip_odometry applies to relative poses).  pose_interp_aug
    # recomputes odometry AND the point warps from pose_seq, so leaving
    # it unflipped made every flipped+interpolated sample's rotation
    # targets/warps mirror-inconsistent with its clouds (yaw sign
    # noise ~ the yaw signal itself — the round-3 rotation collapse).
    if "pose_seq" in sample:
        ps = sample["pose_seq"]
        sample["pose_seq"] = np.stack(
            [flip_odometry(ps[i]) for i in range(len(ps))]).astype(
                np.float32)
    return sample


def rotate_odometry(odom: np.ndarray, Rz: np.ndarray) -> np.ndarray:
    """Conjugate one (7,) pose by a global rotation: R' = Rz R Rz^T,
    t' = Rz t — the same map ``flip_odometry`` applies with F."""
    R = quat_to_matrix_np(odom[3:])
    Rn = Rz @ R @ Rz.T
    q = matrix_to_quat_np(Rn)
    if q[0] != 0:
        q = q * np.sign(q[0])
    return np.concatenate([Rz @ odom[:3], q]).astype(np.float32)


def random_yaw(sample: dict, rng: np.random.Generator,
               max_rad: float) -> dict:
    """Global-yaw augmentation (an extension; the reference only
    y-flips, /root/reference/rslo/data/preprocess.py:335-386).  Rotate
    every frame's points/normals by a single random R_z(theta) and
    conjugate all pair odometries + window poses, decorrelating the
    scene's absolute heading from the rotation targets (the round-4
    OOD-sustained-turn diagnosis).  Mutates and returns the sample."""
    if max_rad <= 0:
        return sample
    th = float(rng.uniform(-max_rad, max_rad))
    c, s = np.cos(th), np.sin(th)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                  np.float64)
    for pts in sample["points"]:
        pts[:, :3] = pts[:, :3] @ Rz.T
        if pts.shape[1] >= 7:
            pts[:, 4:7] = pts[:, 4:7] @ Rz.T     # (x,y,z,i,nx,ny,nz)
        elif pts.shape[1] >= 6:
            pts[:, 3:6] = pts[:, 3:6] @ Rz.T     # (x,y,z,nx,ny,nz)
        if pts.shape[1] >= 10:                   # cross-normal gt cols
            pts[:, 7:10] = pts[:, 7:10] @ Rz.T
    for hp in sample.get("hier_points", []):
        hp[:, :3] = hp[:, :3] @ Rz.T
        hp[:, 3:6] = hp[:, 3:6] @ Rz.T
    odom = sample["odometry"]
    for k in range(len(odom)):
        odom[k] = rotate_odometry(odom[k], Rz)
    if "pose_seq" in sample:
        ps = sample["pose_seq"]
        sample["pose_seq"] = np.stack(
            [rotate_odometry(ps[i], Rz) for i in range(len(ps))]).astype(
                np.float32)
    return sample


def _slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    """Spherical interpolation between two wxyz quaternions; ``u`` may
    lie outside [0, 1] (extrapolation, as the reference's negative
    aug ratios do)."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 1.0 - 1e-8:
        out = q0 + u * (q1 - q0)            # nearly parallel: lerp
    else:
        th = np.arccos(np.clip(d, -1.0, 1.0))
        out = (np.sin((1 - u) * th) * q0 + np.sin(u * th) * q1) / \
            np.sin(th)
    return out / np.linalg.norm(out)


def pose_interp_aug(sample: dict, rng: np.random.Generator,
                    ratio: float) -> dict:
    """Pose-interpolation augmentation (the reference's rand_aug_ratio
    path, /root/reference/rslo/data/preprocess.py:389-458).

    Window-relative absolute poses rel[0]=I, rel[i]=vo(pose_0, pose_i)
    are perturbed by lerping translation / slerping rotation toward the
    NEXT window pose by u_i ~ U(-r, r) (the last frame extrapolates
    from its predecessor); the cyclic-VO targets are regenerated from
    the perturbed poses, and every frame's points AND normals are
    rigidly warped by vo(new_i, old_i) so the augmented supervision
    stays geometrically consistent with the clouds.
    """
    if ratio <= 0:
        return sample
    from ..geometry import np_calc_vo
    from .dataset import generate_cyc_vo

    pose_seq = sample["pose_seq"]
    L = len(pose_seq)
    rel = np.zeros((L, 7), np.float32)
    rel[:, 3] = 1.0
    for i in range(1, L):
        rel[i] = np_calc_vo(pose_seq[0:1], pose_seq[i:i + 1])[0]

    u = rng.uniform(-ratio, ratio, L)
    new_rel = rel.copy()
    for i in range(1, L):
        if i + 1 < L:
            j, ui = i + 1, u[i]
        else:
            j, ui = i - 1, -u[i]            # extrapolate off the last
        new_rel[i, :3] = rel[i, :3] + (rel[j, :3] - rel[i, :3]) * ui
        q = _slerp(rel[i, 3:], rel[j, 3:], ui)
        new_rel[i, 3:] = q * (np.sign(q[0]) if q[0] != 0 else 1.0)

    sample["odometry"] = generate_cyc_vo(new_rel)
    # keep pose_seq consistent: pose_i' = pose_0 ∘ new_rel_i
    from ..geometry import np_compose_pose
    sample["pose_seq"] = np.concatenate(
        [pose_seq[0:1],
         np_compose_pose(np.broadcast_to(pose_seq[0:1], (L - 1, 7)),
                         new_rel[1:])]).astype(np.float32)

    for i in range(1, L):
        T = np_calc_vo(new_rel[i:i + 1], rel[i:i + 1])[0]
        R = quat_to_matrix_np(T[3:])
        pts = sample["points"][i]
        pts[:, :3] = pts[:, :3] @ R.T + T[:3]
        if pts.shape[1] >= 7:
            pts[:, 4:7] = pts[:, 4:7] @ R.T
        elif pts.shape[1] >= 6:
            pts[:, 3:6] = pts[:, 3:6] @ R.T
        if pts.shape[1] >= 10:               # cross-normal gt columns
            pts[:, 7:10] = pts[:, 7:10] @ R.T
        if "hier_points" in sample:          # preprocess.py:451-458
            hp = sample["hier_points"][i]
            hp[:, :3] = hp[:, :3] @ R.T + T[:3]
            hp[:, 3:6] = hp[:, 3:6] @ R.T
    return sample
