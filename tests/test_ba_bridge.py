"""BA bridge: noisy window odometry + shared structure -> refined poses."""
import numpy as np
import jax.numpy as jnp

from rslo_tpu import geometry as G
from rslo_tpu.pgo.ba_bridge import (cov_trace_weights, refine_window_ba,
                                    window_ba_problem)


def make_window(rng, L=4, N=800, noise=0.0):
    """A static structured scene observed from L poses."""
    world = np.concatenate([
        rng.uniform(-20, 20, size=(N // 2, 3)) * [1, 1, 0.05],
        rng.uniform(-20, 20, size=(N // 2, 3)) * [1, 0.05, 1] + [0, 8, 2],
    ]).astype(np.float32)
    gt_poses = np.zeros((L, 7), np.float32)
    gt_poses[:, 3] = 1.0
    for i in range(1, L):
        step = np.array([1.0, 0.05, 0.0, np.cos(0.005), 0, 0,
                         np.sin(0.005)], np.float32)
        gt_poses[i] = G.np_compose_pose(gt_poses[i - 1][None],
                                        step[None])[0]
    frames = []
    for i in range(L):
        inv = G.np_invert_pose(gt_poses[i])
        local = np.asarray(G.transform_points(jnp.asarray(inv),
                                              jnp.asarray(world)))
        local = local + rng.normal(0, 0.005, local.shape)
        frames.append(local.astype(np.float32))
    gt_odoms = np.stack([
        G.np_calc_vo(gt_poses[i][None], gt_poses[i + 1][None])[0]
        for i in range(L - 1)])
    noisy = gt_odoms.copy()
    if noise:
        noisy[:, :3] += rng.normal(0, noise, noisy[:, :3].shape)
    return frames, gt_poses, noisy.astype(np.float32)


def test_window_ba_problem_builds(rng):
    frames, gt_poses, odoms = make_window(rng)
    prob = window_ba_problem(frames, gt_poses)
    assert prob is not None
    assert prob.landmarks.shape[1] == 3
    assert int(prob.obs_pose.shape[0]) > len(frames[0])


def test_refine_window_ba_reduces_error(rng):
    frames, gt_poses, noisy = make_window(rng, noise=0.05)
    refined = refine_window_ba(frames, noisy, iters=6,
                               assoc_threshold=0.8)
    odoms0 = np.zeros((len(frames), 7), np.float32)
    odoms0[:, 3] = 1.0
    odoms0[1:] = noisy
    chained = G.odom_to_abs_pose(odoms0)
    err0 = np.linalg.norm(chained[:, :3] - gt_poses[:, :3], axis=1).mean()
    err1 = np.linalg.norm(refined[:, :3] - gt_poses[:, :3], axis=1).mean()
    assert err1 < err0 * 0.5, (err0, err1)


def test_refine_falls_back_when_sparse(rng):
    frames, gt_poses, noisy = make_window(rng, L=3, N=40, noise=0.05)
    # impossible gate -> too few associations -> fall back to chaining
    refined = refine_window_ba(frames, noisy, assoc_threshold=1e-6)
    odoms0 = np.zeros((3, 7), np.float32)
    odoms0[:, 3] = 1.0
    odoms0[1:] = noisy
    np.testing.assert_allclose(refined, G.odom_to_abs_pose(odoms0),
                               atol=1e-6)


def test_cov_trace_weights():
    params = np.zeros((4, 7), np.float32)
    params[:, 0] = [0.0, 0.1, 1.0, 5.0]
    w = cov_trace_weights(params)
    assert np.all(np.diff(w) < 0)  # bigger covariance -> smaller weight
    assert w[0] == 1.0


def test_cov_weighting_beats_scalar_on_anisotropic_noise(rng):
    """Full-covariance whitening must beat
    scalar-trace weighting when observation noise is anisotropic and
    the per-point covariances describe it."""
    import jax.numpy as jnp
    from rslo_tpu.geometry import (np_calc_vo, np_invert_pose,
                                   quat_to_matrix_np)
    from rslo_tpu.pgo.ba import BAProblem, solve_ba
    from rslo_tpu.pgo.ba_bridge import cov_sqrt_info, cov_trace_weights

    # world landmarks + two extra frames with known poses
    K = 400
    lms = rng.uniform(-8, 8, size=(K, 3)).astype(np.float32)
    lms[:, 2] *= 0.2
    poses = np.zeros((3, 7), np.float32)
    poses[:, 3] = 1.0
    poses[1, :3] = (0.6, 0.15, 0.02)
    poses[2, :3] = (1.2, 0.3, 0.05)
    from rslo_tpu import geometry as G
    q1 = np.asarray(G.qexp(jnp.asarray([0.0, 0.0, 0.02])))
    q2 = np.asarray(G.qexp(jnp.asarray([0.0, 0.0, 0.045])))
    poses[1, 3:] = q1
    poses[2, 3:] = q2

    # RANGE noise: large along each point's viewing ray, tiny
    # tangentially (LiDAR-like).  The direction varies per point, so the
    # full 3x3 model can exploit it while a scalar trace weight sees
    # every point identically.
    s_rad, s_tan = 0.4, 0.005

    def frames_and_covs(i):
        inv = np_invert_pose(poses[i:i + 1])[0]
        R = quat_to_matrix_np(inv[3:])
        local = lms @ R.T + inv[:3]
        d = local / (np.linalg.norm(local, axis=1, keepdims=True) + 1e-9)
        # tangent basis
        up = np.tile(np.array([0.0, 0.0, 1.0]), (K, 1))
        up[np.abs(d[:, 2]) > 0.9] = (1.0, 0.0, 0.0)
        t1 = np.cross(d, up)
        t1 /= np.linalg.norm(t1, axis=1, keepdims=True) + 1e-9
        t2 = np.cross(d, t1)
        noise = (d * rng.normal(0, s_rad, (K, 1)) +
                 t1 * rng.normal(0, s_tan, (K, 1)) +
                 t2 * rng.normal(0, s_tan, (K, 1))).astype(np.float32)
        # cov params: cumulative eigvals (tan, tan, radial) with the
        # eigvec quat rotating e_z onto the ray direction (span_cov's
        # V diag(lam) V' puts lam3 on V's 3rd column)
        cov = np.zeros((K, 7), np.float32)
        cov[:, 0] = s_tan * s_tan
        cov[:, 1] = 0.0
        cov[:, 2] = s_rad * s_rad - s_tan * s_tan
        ez = np.array([0.0, 0.0, 1.0])
        axis = np.cross(np.tile(ez, (K, 1)), d)
        sn = np.linalg.norm(axis, axis=1)
        cs = d[:, 2]
        ang = np.arctan2(sn, cs)
        axis = axis / (sn[:, None] + 1e-12)
        cov[:, 3] = np.cos(ang / 2)
        cov[:, 4:7] = axis * np.sin(ang / 2)[:, None]
        return local, noise, cov

    obs_p, obs_l, obs_x = [], [], []
    covs_per_obs = []
    for i in range(3):
        local, noise, cov = frames_and_covs(i)
        for j in range(K):
            obs_p.append(i)
            obs_l.append(j)
            obs_x.append(local[j] + noise[j])
        covs_per_obs.append(cov)
    covs_per_obs = np.concatenate(covs_per_obs)

    anchor = np.zeros(3, bool)
    anchor[0] = True
    # perturb initial poses
    poses0 = poses.copy()
    poses0[1, :3] += (0.05, -0.04, 0.02)
    poses0[2, :3] += (-0.06, 0.05, -0.02)

    def solve_with(w):
        prob = BAProblem(
            jnp.asarray(poses0), jnp.asarray(lms + 0.0),
            jnp.asarray(obs_p, jnp.int32), jnp.asarray(obs_l, jnp.int32),
            jnp.asarray(np.stack(obs_x)), jnp.asarray(w),
            jnp.asarray(anchor))
        out, _ = solve_ba(prob, iters=6)
        got = np.asarray(out.poses)
        return np.linalg.norm(got[1:, :3] - poses[1:, :3])

    w_scalar = cov_trace_weights(covs_per_obs)
    W_full = cov_sqrt_info(covs_per_obs, eps=1e-6)
    err_scalar = solve_with(w_scalar)
    err_full = solve_with(W_full)
    # full 3D error model must at least halve the pose error
    assert err_full < 0.5 * err_scalar, (err_full, err_scalar)


def test_cov_sqrt_info_whitens():
    import jax.numpy as jnp
    from rslo_tpu.losses.consistency import span_cov
    from rslo_tpu.pgo.ba_bridge import cov_sqrt_info
    cov_params = np.array([[0.01, 0.03, 0.4, 0.9, 0.1, 0.3, 0.2]],
                          np.float32)
    W = cov_sqrt_info(cov_params, eps=1e-4)[0]
    sigma = np.asarray(span_cov(jnp.asarray(cov_params)))[0] + \
        1e-4 * np.eye(3)
    np.testing.assert_allclose(W.T @ W, np.linalg.inv(sigma),
                               rtol=1e-3, atol=1e-3)
