"""Raycast synthetic LiDAR world — the accuracy-proxy data source.

The round-1 generator (:mod:`rslo_tpu.utils.synthetic`) re-transforms
ONE point sample per sequence, so every frame sees the same surface
samples and there is no occlusion or viewpoint dependence.  This module
builds a persistent 3D world (undulating ground, wall rectangles,
boxes, cylinders) and renders each frame by casting a spinning-scanner
ray grid from the sensor pose:

  * independent surface samples per frame (range changes the sample),
  * true occlusion (nearest hit along each ray wins),
  * viewpoint-dependent dropout at grazing incidence + max range,
  * per-ray range noise along the beam (LiDAR-like anisotropy),
  * analytic normals (flipped toward the sensor).

This is the evidence path for the accuracy question the reference task
poses (KITTI odometry quality, /root/reference/rslo/data/
kitti_dataset_hdf5.py:331-509 + rslo/utils/kitti_evaluation.py:97-238):
scans are written as a KITTI-shaped raw tree and driven through the
production create_hdf5 -> train -> evaluate pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..geometry import (matrix_to_quat_np, np_calc_vo, np_compose_pose,
                        quat_to_matrix_np)


@dataclass
class _Rect:
    p0: np.ndarray      # (3,) corner
    u: np.ndarray       # (3,) edge 1 (p0 -> p0+u)
    v: np.ndarray       # (3,) edge 2
    n: np.ndarray       # (3,) unit normal
    refl: float         # base reflectivity


class SynthWorld:
    """A static scene of ground + rectangles + cylinders.

    extent: half-size of the populated square (metres).
    """

    def __init__(self, seed: int = 0, extent: float = 160.0,
                 n_walls: int = 90, n_boxes: int = 40,
                 n_cyl: int = 60, corridor: float = 7.0):
        rng = np.random.default_rng(seed)
        self.extent = extent
        self.ground_z = -1.72
        self.g_amp = 0.15
        self.g_fx = rng.uniform(0.015, 0.035)
        self.g_fy = rng.uniform(0.015, 0.035)
        self.g_refl = 0.15

        rects = []

        def add_wall(cx, cy, yaw, length, height, refl):
            d = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            z0 = self._ground(np.array([[cx, cy]]))[0]
            p0 = np.array([cx, cy, z0]) - d * (length / 2)
            u = d * length
            v = np.array([0.0, 0.0, height])
            n = np.array([-d[1], d[0], 0.0])
            rects.append(_Rect(p0, u, v, n, refl))

        # free-standing walls (building facades)
        for _ in range(n_walls):
            cx, cy = rng.uniform(-extent, extent, 2)
            if abs(cy) < corridor:       # keep the drive corridor open
                cy = np.sign(cy or 1.0) * (corridor + abs(cy))
            add_wall(cx, cy, rng.uniform(0, np.pi),
                     rng.uniform(4, 25), rng.uniform(2, 8),
                     rng.uniform(0.3, 0.9))
        # boxes (cars/cabins): 4 vertical faces
        for _ in range(n_boxes):
            cx, cy = rng.uniform(-extent, extent, 2)
            if abs(cy) < corridor:
                cy = np.sign(cy or 1.0) * (corridor + abs(cy))
            yaw = rng.uniform(0, np.pi)
            lx, ly = rng.uniform(1.5, 6.0), rng.uniform(1.2, 2.8)
            h = rng.uniform(1.2, 2.2)
            refl = rng.uniform(0.4, 1.0)
            c, s = np.cos(yaw), np.sin(yaw)
            ex = np.array([c, s, 0.0]) * lx / 2
            ey = np.array([-s, c, 0.0]) * ly / 2
            ctr = np.array([cx, cy, 0.0])
            z0 = self._ground(np.array([[cx, cy]]))[0]
            up = np.array([0.0, 0.0, h])
            for sgn, e_face, e_run in ((1, ey, ex), (-1, ey, ex),
                                       (1, ex, ey), (-1, ex, ey)):
                p0 = ctr + sgn * e_face - e_run
                p0[2] = z0
                nrm = sgn * e_face / np.linalg.norm(e_face)
                rects.append(_Rect(p0, 2 * e_run, up, nrm, refl))
        self.rects = rects
        # cylinders (poles / trunks)
        cyl = []
        for _ in range(n_cyl):
            cx, cy = rng.uniform(-extent, extent, 2)
            if abs(cy) < corridor - 2.0:
                cy = np.sign(cy or 1.0) * (corridor + abs(cy))
            cyl.append((cx, cy, rng.uniform(0.08, 0.5),
                        rng.uniform(2.5, 9.0), rng.uniform(0.2, 0.6)))
        self.cyls = np.array(cyl) if cyl else np.zeros((0, 5))

        # pack rectangles for vectorized intersection
        if rects:
            self._rp0 = np.stack([r.p0 for r in rects])
            self._ru = np.stack([r.u for r in rects])
            self._rv = np.stack([r.v for r in rects])
            self._rn = np.stack([r.n for r in rects])
            self._rrefl = np.array([r.refl for r in rects])
            self._ru2 = np.einsum("ij,ij->i", self._ru, self._ru)
            self._rv2 = np.einsum("ij,ij->i", self._rv, self._rv)

    # -- ground heightfield ------------------------------------------------
    def _ground(self, xy: np.ndarray) -> np.ndarray:
        return (self.ground_z + self.g_amp *
                np.sin(xy[..., 0] * self.g_fx * 2 * np.pi) *
                np.sin(xy[..., 1] * self.g_fy * 2 * np.pi))

    def _ground_normal(self, xy: np.ndarray) -> np.ndarray:
        two_pi = 2 * np.pi
        dzdx = (self.g_amp * self.g_fx * two_pi *
                np.cos(xy[..., 0] * self.g_fx * two_pi) *
                np.sin(xy[..., 1] * self.g_fy * two_pi))
        dzdy = (self.g_amp * self.g_fy * two_pi *
                np.sin(xy[..., 0] * self.g_fx * two_pi) *
                np.cos(xy[..., 1] * self.g_fy * two_pi))
        n = np.stack([-dzdx, -dzdy, np.ones_like(dzdx)], axis=-1)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    # -- scan --------------------------------------------------------------
    def scan(self, pose_tq: np.ndarray, rng: np.random.Generator,
             n_beams: int = 64, n_azimuth: int = 2048,
             max_range: float = 75.0, range_sigma: float = 0.02,
             min_range: float = 2.2) -> np.ndarray:
        """Render one frame from sensor pose (world frame, tq wxyz).

        Returns (N, 7) float32: x, y, z, intensity, nx, ny, nz in the
        SENSOR frame, normals flipped toward the origin; N varies with
        the scene (misses are dropped)."""
        R = quat_to_matrix_np(pose_tq[3:])
        origin = pose_tq[:3].astype(np.float64)

        elev = np.deg2rad(np.linspace(2.0, -24.0, n_beams))
        azim = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
        az, el = np.meshgrid(azim, elev)
        d_sensor = np.stack([np.cos(el) * np.cos(az),
                             np.cos(el) * np.sin(az),
                             np.sin(el)], axis=-1).reshape(-1, 3)
        d = d_sensor @ R.T                       # world-frame directions
        nrays = d.shape[0]

        best_t = np.full(nrays, np.inf)
        best_n = np.zeros((nrays, 3))
        best_refl = np.zeros(nrays)

        # ground: plane solve + 2 Newton refinements on the undulation
        dz = d[:, 2]
        t = np.where(np.abs(dz) > 1e-9,
                     (self.ground_z - origin[2]) / np.where(
                         np.abs(dz) > 1e-9, dz, 1.0), np.inf)
        for _ in range(2):
            hit_xy = origin[None, :2] + t[:, None] * d[:, :2]
            gz = self._ground(hit_xy)
            t = np.where(np.abs(dz) > 1e-9,
                         t + (gz - (origin[2] + t * dz)) / np.where(
                             np.abs(dz) > 1e-9, dz, 1.0), np.inf)
        ok = (t > min_range) & (t < max_range) & np.isfinite(t)
        upd = ok & (t < best_t)
        if np.any(upd):
            hxy = origin[None, :2] + t[:, None] * d[:, :2]
            best_t[upd] = t[upd]
            best_n[upd] = self._ground_normal(hxy[upd])
            best_refl[upd] = self.g_refl

        # rectangles, vectorized (chunked R rays x W rects, f32): the
        # in-plane coords of the hitpoint are affine in t, so the inside
        # test needs only (R, W) broadcasts of precomputed dot products
        # (a = (t d.u - po.u)/|u|^2), never (R, W, 3) intermediates.
        d32 = d.astype(np.float32)
        if self.rects:
            rn = self._rn.astype(np.float32)
            ru = self._ru.astype(np.float32)
            rv = self._rv.astype(np.float32)
            po = (self._rp0 - origin[None]).astype(np.float32)   # (W, 3)
            num = (po * rn).sum(-1)                              # (W,)
            pou = (po * ru).sum(-1)
            pov = (po * rv).sum(-1)
            u2 = self._ru2.astype(np.float32)
            v2 = self._rv2.astype(np.float32)
            chunk = 32768
            for s in range(0, nrays, chunk):
                dch = d32[s:s + chunk]
                dn = dch @ rn.T                                   # (r, W)
                with np.errstate(divide="ignore", invalid="ignore"):
                    tw = num[None] / dn
                    tw = np.where(np.abs(dn) > 1e-9, tw, np.inf)
                    a = (tw * (dch @ ru.T) - pou[None]) / u2[None]
                    b = (tw * (dch @ rv.T) - pov[None]) / v2[None]
                valid = ((tw > min_range) & (tw < max_range) &
                         (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1))
                tw = np.where(valid, tw, np.inf)
                j = np.argmin(tw, axis=1)
                rows = np.arange(tw.shape[0])
                t_f = tw[rows, j]
                upd = t_f < best_t[s:s + chunk]
                rf = rows[upd]
                best_t[s + rf] = t_f[rf]
                best_n[s + rf] = self._rn[j[rf]]
                best_refl[s + rf] = self._rrefl[j[rf]]

        # cylinders, vectorized (R rays x C cylinders, f32)
        if len(self.cyls):
            cxs = self.cyls[:, 0].astype(np.float32)
            cys = self.cyls[:, 1].astype(np.float32)
            rads = self.cyls[:, 2].astype(np.float32)
            hs = self.cyls[:, 3].astype(np.float32)
            refls = self.cyls[:, 4]
            zgs = self._ground(self.cyls[:, :2]).astype(np.float32)
            ox = np.float32(origin[0]) - cxs                    # (C,)
            oy = np.float32(origin[1]) - cys
            dx, dy, dzr = d32[:, 0:1], d32[:, 1:2], d32[:, 2:3]
            a = dx * dx + dy * dy                               # (R, 1)
            b = 2 * (ox[None] * dx + oy[None] * dy)             # (R, C)
            c = (ox * ox + oy * oy - rads * rads)[None]
            disc = b * b - 4 * a * c
            with np.errstate(invalid="ignore", divide="ignore"):
                tc = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
            zhit = np.float32(origin[2]) + tc * dzr
            ok = ((disc > 0) & (tc > min_range) & (tc < max_range) &
                  (zhit > zgs[None]) & (zhit < (zgs + hs)[None]))
            tc = np.where(ok, tc, np.inf)
            j = np.argmin(tc, axis=1)
            rows = np.arange(nrays)
            t_f = tc[rows, j]
            upd = t_f < best_t
            rf = rows[upd]
            jf = j[rf]
            hxy = origin[None, :2] + t_f[rf, None] * d[rf, :2]
            nrm = np.concatenate(
                [hxy - np.stack([cxs[jf], cys[jf]], axis=1),
                 np.zeros((len(rf), 1))], axis=1)
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-12
            best_t[rf] = t_f[rf]
            best_n[rf] = nrm
            best_refl[rf] = refls[jf]

        hit_mask = np.isfinite(best_t)
        # grazing-incidence dropout: return probability falls with the
        # cosine between the beam and the surface normal
        cosg = np.abs((d * best_n).sum(-1))
        keep_p = np.clip(0.15 + 0.9 * cosg, 0, 1)
        # distant-return dropout
        with np.errstate(invalid="ignore"):
            keep_p = keep_p * np.clip(1.6 - best_t / max_range, 0, 1)
        hit_mask &= rng.uniform(size=nrays) < keep_p

        idx = np.nonzero(hit_mask)[0]
        t_noisy = best_t[idx] + rng.normal(0, range_sigma, len(idx))
        pts_w = origin[None] + t_noisy[:, None] * d[idx]
        # sensor frame: x_s = R^T (x_w - t)
        pts_s = (pts_w - origin) @ R
        n_w = best_n[idx]
        # flip normals toward the sensor (PCA normals are unoriented;
        # the reference orients them toward the origin)
        flip = (n_w * d[idx]).sum(-1) > 0
        n_w = np.where(flip[:, None], -n_w, n_w)
        n_s = n_w @ R
        inten = np.clip(best_refl[idx] *
                        rng.normal(1.0, 0.08, len(idx)), 0, 1)
        out = np.concatenate(
            [pts_s, inten[:, None], n_s], axis=1).astype(np.float32)
        return out[rng.permutation(len(out))]


def synth_trajectory(seed: int = 0, n_frames: int = 200,
                     pattern: str = "curve", speed: float = 8.0,
                     dt: float = 0.1,
                     speed_profile: str = "walk") -> np.ndarray:
    """Smooth SE(3) trajectory in the world frame: (n_frames, 7) tq.

    pattern "curve": wandering yaw-rate drive (KITTI-like);
    pattern "loop": closed circuit that revisits its start (for
    loop-closure evaluation).

    speed_profile "walk": small random-walk around ``speed`` (+-50%,
    the original behavior — near-constant over window timescales).
    "varied": piecewise speed targets (log-uniform 0.3-1.8x ``speed``
    plus occasional near-stops) approached under a 2 m/s^2 accel limit
    — urban-drive magnitude diversity, so translation-norm regression
    cannot collapse to a per-sequence constant.  KITTI itself spans
    0-~23 m/s within sequences; the "walk" proxy's near-constant speed
    trained a magnitude-compressed translation head.  Curve-pattern yaw rate is scaled by v/speed in varied mode
    (constant curvature, Ackermann-like), so slow segments turn
    slowly in place rather than spinning.  "varied" only applies to
    pattern "curve"; loops keep the closure-timed yaw drive.

    "urban" (world v3): varied's speed profile with the UNSCALED yaw
    drive.  Measured on v2 stores (r4): the yaw-prop-to-v coupling
    halved train yaw magnitudes (0.47-0.58 vs 1.22 deg/frame mean) and
    made |yaw| predictable from speed (corr up to +0.72) — rotation
    SNR collapsed and supervised 3k-step controls could not learn yaw
    at all.  Decoupling restores v1's rotation signal
    while keeping the translation-magnitude diversity."""
    rng = np.random.default_rng(seed + 17)
    yaw = rng.uniform(0, 2 * np.pi)
    pos = np.array([0.0, 0.0, 0.0])
    poses = []
    if pattern in ("loop", "loop_cw"):
        # constant-ish turn closing a circle over ~80% of the frames,
        # then continue past the start for revisit overlap
        # ("loop_cw": clockwise — the v4 seqset trains on sustained
        # turning in BOTH directions, see accuracy_proxy.SEQS)
        circ_frames = int(n_frames * 0.8)
        yaw_rate0 = 2 * np.pi / (circ_frames * dt)
        if pattern == "loop_cw":
            yaw_rate0 = -yaw_rate0
    v = speed
    varied = speed_profile in ("varied", "urban") and pattern == "curve"
    scale_yaw = speed_profile == "varied"
    v_tgt, next_switch = speed, 0
    for i in range(n_frames):
        if pattern in ("loop", "loop_cw"):
            yr = yaw_rate0 * (1 + 0.05 * np.sin(i * 0.05))
        else:
            yr = 0.35 * np.sin(i * 0.02 + rng.uniform(-0.1, 0.1)) + \
                rng.normal(0, 0.02)
        if varied:
            if i >= next_switch:
                if rng.uniform() < 0.15:
                    v_tgt = rng.uniform(0.3, 1.5)      # near-stop
                else:
                    v_tgt = speed * np.exp(
                        rng.uniform(np.log(0.3), np.log(1.8)))
                next_switch = i + int(rng.integers(30, 90))
            dv = np.clip(v_tgt - v, -2.0 * dt, 2.0 * dt)
            v = max(v + dv + rng.normal(0, 0.05), 0.0)
            if scale_yaw:
                yr = yr * (v / speed)
        else:
            v = np.clip(v + rng.normal(0, 0.15), speed * 0.5,
                        speed * 1.5)
        yaw += yr * dt
        pos = pos + v * dt * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        z = 0.0 + 0.03 * np.sin(i * 0.05)
        pitch = 0.01 * np.sin(i * 0.08)
        cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
        cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
        # q = qz(yaw) * qy(pitch)
        q = np.array([cy * cp, -sy * sp, cy * sp, sy * cp])
        poses.append(np.array([pos[0], pos[1], z, *q], np.float32))
    return np.stack(poses)


def render_sequence(world: SynthWorld, poses: np.ndarray, seed: int = 0,
                    n_beams: int = 64, n_azimuth: int = 2048,
                    progress: bool = False):
    """Render frames along a trajectory.

    Returns (frames list[(Ni, 7) sensor-frame], odom (n-1, 7) tq)
    where odom[i] is the motion frame i -> i+1 (np_calc_vo)."""
    rng = np.random.default_rng(seed + 1234)
    frames = []
    for i, p in enumerate(poses):
        frames.append(world.scan(p, rng, n_beams=n_beams,
                                 n_azimuth=n_azimuth))
        if progress and (i % 20 == 0):
            print(f"  rendered {i}/{len(poses)}", flush=True)
    odom = np_calc_vo(poses[:-1], poses[1:]).astype(np.float32)
    return frames, odom


def write_kitti_tree(root, seqs: dict, world_seed: int = 0,
                     n_beams: int = 64, n_azimuth: int = 2048,
                     progress: bool = False, world_kwargs: dict = None,
                     speed_profile: str = "walk"):
    """Write rendered sequences as a KITTI odometry raw tree consumable
    by ``cli create_hdf5`` (velodyne .bin + camera-frame poses + calib).

    seqs: {seq_id: (n_frames, pattern, speed)}.  world_kwargs lets
    small-scale tests shrink the world (extent / object counts).
    Returns {seq_id: (lidar_poses (N,7), odom (N-1,7))}.
    """
    from pathlib import Path
    root = Path(root)
    Tr = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                   [0, 0, 0, 1]], float)
    out = {}
    world = SynthWorld(seed=world_seed, **(world_kwargs or {}))
    for seq, (n_frames, pattern, speed) in seqs.items():
        seq_dir = root / "sequences" / f"{seq:02d}"
        (seq_dir / "velodyne").mkdir(parents=True, exist_ok=True)
        (root / "poses").mkdir(exist_ok=True)
        with open(seq_dir / "calib.txt", "w") as f:
            P = "7.1e+02 0 6.0e+02 0 0 7.1e+02 1.8e+02 0 0 0 1 0"
            for k in ("P0", "P1", "P2", "P3"):
                f.write(f"{k}: {P}\n")
            f.write("Tr: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
        poses = synth_trajectory(seed=world_seed * 100 + seq,
                                 n_frames=n_frames, pattern=pattern,
                                 speed=speed,
                                 speed_profile=speed_profile)
        frames, odom = render_sequence(world, poses,
                                       seed=world_seed * 100 + seq,
                                       n_beams=n_beams,
                                       n_azimuth=n_azimuth,
                                       progress=progress)
        cam_rows = []
        for i, (fr, p) in enumerate(zip(frames, poses)):
            fr[:, :4].astype(np.float32).tofile(
                seq_dir / "velodyne" / f"{i:06d}.bin")
            from ..geometry import tq_to_RT
            T_l = np.eye(4)
            T_l[:3] = tq_to_RT(p)
            T_c = Tr @ T_l @ np.linalg.inv(Tr)
            cam_rows.append(T_c[:3].reshape(-1))
        np.savetxt(root / "poses" / f"{seq:02d}.txt", np.stack(cam_rows))
        out[seq] = (poses, odom)
        if progress:
            npts = int(np.mean([len(f) for f in frames]))
            print(f"seq {seq}: {n_frames} frames, ~{npts} pts/frame",
                  flush=True)
    return out
