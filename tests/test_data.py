"""Data layer: HDF5 store roundtrip, window dataset, loader, augment."""
import numpy as np
import pytest

from rslo_tpu.config.schema import DataCfg
from rslo_tpu.data.augment import flip_odometry, random_flip_y
from rslo_tpu.data.loader import DataLoader, TrainSampler, collate, pad_points
from rslo_tpu import geometry as G


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """Synthesize a minimal KITTI tree (2 sequences x 8 frames) and build
    the HDF5 store from it."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for seq in (0, 1):
        seq_dir = root / "sequences" / f"{seq:02d}"
        (seq_dir / "velodyne").mkdir(parents=True)
        (root / "poses").mkdir(exist_ok=True)
        with open(seq_dir / "calib.txt", "w") as f:
            P = "7.1e+02 0 6.0e+02 0 0 7.1e+02 1.8e+02 0 0 0 1 0"
            for k in ("P0", "P1", "P2", "P3"):
                f.write(f"{k}: {P}\n")
            f.write("Tr: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
        poses = []
        for i in range(8):
            pts = rng.uniform(-10, 10, size=(512, 4)).astype(np.float32)
            pts[:, 3] = rng.uniform(0, 1, 512)
            pts.tofile(seq_dir / "velodyne" / f"{i:06d}.bin")
            T = np.eye(4)[:3]
            T[0, 3] = 0.1 * i  # camera x translation
            poses.append(T.reshape(-1))
        np.savetxt(root / "poses" / f"{seq:02d}.txt", np.stack(poses))
    out = root / "all.h5"
    from rslo_tpu.data.hdf5_store import create_hdf5
    create_hdf5(str(root), str(out), sequences=(0, 1), progress=False)
    return str(out)


def test_hdf5_roundtrip(mini_kitti):
    from rslo_tpu.data.hdf5_store import SequenceReader
    r = SequenceReader(mini_kitti, 0)
    assert r.n_frames == 8
    fr = r.frame(3)
    assert fr["points"].shape[1] == 7
    # normals unit-length
    nn = np.linalg.norm(fr["points"][:, 4:7], axis=1)
    np.testing.assert_allclose(nn, 1.0, atol=1e-4)
    assert "hier_lidar_points_normals_0.1" in fr


def test_window_dataset(mini_kitti):
    cfg = DataCfg(root=mini_kitti, seq_length=3, skip=1,
                  train_sequences=(0, 1), val_sequences=(0,))
    from rslo_tpu.data.dataset import KittiWindowDataset
    ds = KittiWindowDataset(cfg, "train")
    assert len(ds) == 2 * (8 - 2)
    s = ds[0]
    assert len(s["points"]) == 3
    assert s["odometry"].shape == (3, 7)
    # camera x translation maps to lidar frame via Tr: cam x = -lidar y
    vo01 = s["odometry"][0]
    np.testing.assert_allclose(np.abs(vo01[:3]).max(), 0.1, atol=1e-5)
    # quaternions hemisphere-normalized identity
    np.testing.assert_allclose(vo01[3], 1.0, atol=1e-5)


def test_flip_odometry_involution(rng):
    odom = np.concatenate([rng.normal(size=3),
                           np.asarray(G.qnormalize(
                               np.float32(rng.normal(size=4))))]).astype(
                                   np.float32)
    odom[3:] *= np.sign(odom[3])
    twice = flip_odometry(flip_odometry(odom))
    np.testing.assert_allclose(twice, odom, atol=1e-5)


def test_random_flip_consistency(rng):
    """Flipped points + flipped odometry must remain geometrically
    consistent: transform(flip(p)) == flip(transform(p))."""
    pts = rng.normal(size=(64, 7)).astype(np.float32)
    pose = np.concatenate([rng.normal(size=3) * 0.1,
                           np.asarray(G.qexp(np.float32(
                               rng.normal(size=3) * 0.1)))]).astype(
                                   np.float32)
    sample = {"points": [pts.copy(), pts.copy()],
              "odometry": np.stack([pose])}

    class AlwaysFlip:
        def random(self):
            return 1.0
    flipped = random_flip_y({"points": [p.copy() for p in sample["points"]],
                             "odometry": sample["odometry"].copy()},
                            AlwaysFlip())
    F = np.diag([1., -1., 1.])
    xyz = pts[:, :3]
    want = (F @ np.asarray(G.transform_points(
        pose, xyz)).T).T
    got = np.asarray(G.transform_points(flipped["odometry"][0],
                                        (F @ xyz.T).T))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_pad_points_and_collate(rng):
    cfg = DataCfg(max_points=128)
    p, m = pad_points(rng.normal(size=(100, 7)).astype(np.float32), 128)
    assert m.sum() == 100 and p.shape == (128, 7)
    p2, m2 = pad_points(rng.normal(size=(300, 7)).astype(np.float32), 128)
    assert m2.all()
    samples = [{"points": [rng.normal(size=(50, 7)).astype(np.float32)
                           for _ in range(2)],
                "odometry": np.zeros((1, 7), np.float32),
                "seq": 0, "frames": (0, 1)} for _ in range(3)]
    batch = collate(samples, cfg)
    assert batch["points"].shape == (3, 2, 128, 7)
    assert batch["point_mask"].sum() == 3 * 2 * 50


def test_train_sampler_resumes():
    s1 = iter(TrainSampler(10, 100, 2, seed=5))
    first = [next(s1) for _ in range(8)]
    s2 = iter(TrainSampler(10, 100, 2, seed=5, last_iter=1))
    resumed = [next(s2) for _ in range(4)]
    assert first[4:8] == resumed


def test_dataloader_stream(mini_kitti):
    cfg = DataCfg(root=mini_kitti, seq_length=2, max_points=1024,
                  train_sequences=(0,), val_sequences=(1,))
    from rslo_tpu.data.dataset import KittiWindowDataset
    ds = KittiWindowDataset(cfg, "train")
    dl = DataLoader(ds, cfg, device_batch=2, total_steps=3, train=True)
    batches = []
    for i, b in enumerate(dl):
        batches.append(b)
        if i == 2:
            break
    dl.close()
    assert batches[0]["points"].shape[0] == 2
    assert batches[0]["odometry"].shape == (2, 1, 7)


def test_pose_interp_aug_consistency(rng):
    """Slerp pose augmentation: warped points must stay consistent with
    the regenerated cyclic-VO targets — for clouds observing the same
    world points X from poses T_i, after augmentation
    vo'(i,j) ∘ p'_j == p'_i exactly."""
    from rslo_tpu.data.augment import pose_interp_aug
    from rslo_tpu.data.dataset import generate_cyc_vo
    from rslo_tpu.geometry.transforms import (np_calc_vo, np_compose_pose,
                                              np_invert_pose,
                                              quat_to_matrix_np)

    X = rng.normal(size=(256, 3)).astype(np.float32) * 5
    L = 3
    poses = np.zeros((L, 7), np.float32)
    poses[:, 3] = 1.0
    for i in range(1, L):
        ax = rng.normal(size=3) * 0.05
        q = np.asarray(G.qexp(np.float32(ax)))
        poses[i] = np.concatenate(
            [rng.normal(size=3).astype(np.float32) * 0.5, q])
    pts = []
    for i in range(L):
        inv = np_invert_pose(poses[i:i + 1])[0]
        R = quat_to_matrix_np(inv[3:])
        local = X @ R.T + inv[:3]
        nrm = rng.normal(size=(256, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        inten = rng.uniform(0, 1, size=(256, 1)).astype(np.float32)
        pts.append(np.concatenate([local, inten, nrm],
                                  axis=1).astype(np.float32))
    sample = {"points": pts, "pose_seq": poses.copy(),
              "odometry": generate_cyc_vo(poses)}
    out = pose_interp_aug(sample, rng, ratio=0.4)

    # the augmentation must actually change the targets
    assert not np.allclose(out["odometry"], generate_cyc_vo(poses),
                           atol=1e-4)
    offsets = [(i, j) for i in range(L) for j in range(i + 1, L)]
    for k, (i, j) in enumerate(offsets):
        vo = out["odometry"][k]
        R = quat_to_matrix_np(vo[3:])
        mapped = out["points"][j][:, :3] @ R.T + vo[:3]
        np.testing.assert_allclose(mapped, out["points"][i][:, :3],
                                   atol=1e-4)
        # normals rotate with the pose
        mapped_n = out["points"][j][:, 4:7] @ R.T
        # frame i's normals were rotated from the same originals
        voi = np_calc_vo(out["pose_seq"][i:i + 1],
                         out["pose_seq"][j:j + 1])[0]
        np.testing.assert_allclose(voi, vo, atol=1e-4)
        del mapped_n


def test_flip_then_pose_interp_consistency(rng):
    """Round-3 rotation-collapse regression: random_flip_y mutates the
    points and pair odometry, and pose_interp_aug then recomputes BOTH
    the odometry and the point warps from ``pose_seq`` — so the flip
    must mirror pose_seq too, or every flipped+interpolated sample gets
    mirror-inconsistent (yaw-sign-noised) rotation targets."""
    from rslo_tpu.data.augment import pose_interp_aug, random_flip_y
    from rslo_tpu.data.dataset import generate_cyc_vo
    from rslo_tpu.geometry.transforms import (np_invert_pose,
                                              quat_to_matrix_np)

    X = rng.normal(size=(256, 3)).astype(np.float32) * 5
    L = 3
    poses = np.zeros((L, 7), np.float32)
    poses[:, 3] = 1.0
    for i in range(1, L):
        q = np.asarray(G.qexp(np.float32(rng.normal(size=3) * 0.05)))
        poses[i] = np.concatenate(
            [rng.normal(size=3).astype(np.float32) * 0.5, q])
    pts = []
    for i in range(L):
        inv = np_invert_pose(poses[i:i + 1])[0]
        R = quat_to_matrix_np(inv[3:])
        local = X @ R.T + inv[:3]
        nrm = rng.normal(size=(256, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        inten = rng.uniform(0, 1, size=(256, 1)).astype(np.float32)
        pts.append(np.concatenate([local, inten, nrm],
                                  axis=1).astype(np.float32))
    sample = {"points": pts, "pose_seq": poses.copy(),
              "odometry": generate_cyc_vo(poses)}

    class AlwaysFlip:
        def random(self):
            return 1.0

    out = random_flip_y(sample, AlwaysFlip())
    out = pose_interp_aug(out, rng, ratio=0.4)
    offsets = [(i, j) for i in range(L) for j in range(i + 1, L)]
    for k, (i, j) in enumerate(offsets):
        vo = out["odometry"][k]
        R = quat_to_matrix_np(vo[3:])
        mapped = out["points"][j][:, :3] @ R.T + vo[:3]
        np.testing.assert_allclose(mapped, out["points"][i][:, :3],
                                   atol=1e-4)


def _rigid_window_sample(rng, L=3, n=256):
    """Clouds of the same world points X observed from L random poses,
    with unit normals + intensity, plus consistent pose_seq/odometry."""
    from rslo_tpu.data.dataset import generate_cyc_vo
    from rslo_tpu.geometry.transforms import (np_invert_pose,
                                              quat_to_matrix_np)
    X = rng.normal(size=(n, 3)).astype(np.float32) * 5
    poses = np.zeros((L, 7), np.float32)
    poses[:, 3] = 1.0
    for i in range(1, L):
        q = np.asarray(G.qexp(np.float32(rng.normal(size=3) * 0.05)))
        poses[i] = np.concatenate(
            [rng.normal(size=3).astype(np.float32) * 0.5, q])
    pts = []
    for i in range(L):
        inv = np_invert_pose(poses[i:i + 1])[0]
        R = quat_to_matrix_np(inv[3:])
        local = X @ R.T + inv[:3]
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        inten = rng.uniform(0, 1, size=(n, 1)).astype(np.float32)
        pts.append(np.concatenate([local, inten, nrm],
                                  axis=1).astype(np.float32))
    return {"points": pts, "pose_seq": poses.copy(),
            "odometry": generate_cyc_vo(poses)}


def test_random_yaw_consistency(rng):
    """Global-yaw aug: rotated points + conjugated odometry must stay
    rigidly consistent (vo'(i,j) ∘ p'_j == p'_i), pose_seq must agree
    with the pair targets, and normals must stay unit."""
    from rslo_tpu.data.augment import random_yaw
    from rslo_tpu.geometry.transforms import np_calc_vo, quat_to_matrix_np
    L = 3
    sample = _rigid_window_sample(rng, L=L)
    before = sample["odometry"].copy()
    out = random_yaw(sample, rng, max_rad=np.pi)
    assert not np.allclose(out["odometry"], before, atol=1e-4)
    offsets = [(i, j) for i in range(L) for j in range(i + 1, L)]
    for k, (i, j) in enumerate(offsets):
        vo = out["odometry"][k]
        R = quat_to_matrix_np(vo[3:])
        mapped = out["points"][j][:, :3] @ R.T + vo[:3]
        np.testing.assert_allclose(mapped, out["points"][i][:, :3],
                                   atol=1e-4)
        voi = np_calc_vo(out["pose_seq"][i:i + 1],
                         out["pose_seq"][j:j + 1])[0]
        np.testing.assert_allclose(voi, vo, atol=1e-4)
    for p in out["points"]:
        np.testing.assert_allclose(
            np.linalg.norm(p[:, 4:7], axis=1), 1.0, atol=1e-5)


def test_flip_yaw_interp_chain_consistency(rng):
    """The full train-time aug chain (flip -> yaw -> interp) must leave
    points/odometry rigidly consistent — the loader applies all three."""
    from rslo_tpu.data.augment import (pose_interp_aug, random_flip_y,
                                       random_yaw)
    from rslo_tpu.geometry.transforms import quat_to_matrix_np
    L = 3
    sample = _rigid_window_sample(rng, L=L)

    class AlwaysFlip:
        def random(self):
            return 1.0

    out = random_flip_y(sample, AlwaysFlip())
    out = random_yaw(out, rng, max_rad=np.pi)
    out = pose_interp_aug(out, rng, ratio=0.4)
    offsets = [(i, j) for i in range(L) for j in range(i + 1, L)]
    for k, (i, j) in enumerate(offsets):
        vo = out["odometry"][k]
        R = quat_to_matrix_np(vo[3:])
        mapped = out["points"][j][:, :3] @ R.T + vo[:3]
        np.testing.assert_allclose(mapped, out["points"][i][:, :3],
                                   atol=1e-4)


def test_random_skip_sampling(mini_kitti):
    cfg = DataCfg(root=mini_kitti, seq_length=3, skip=2, random_skip=True,
                  train_sequences=(0,), val_sequences=(1,))
    from rslo_tpu.data.dataset import KittiWindowDataset
    ds = KittiWindowDataset(cfg, "train")
    assert ds.supports_random_skip
    rng = np.random.default_rng(0)
    strides = set()
    for _ in range(16):
        s = ds.sample(0, rng)
        fr = s["frames"]
        strides.add(fr[1] - fr[0])
        assert all(0 <= f < 8 for f in fr)
        # targets always match the actually loaded frames
        assert s["odometry"].shape == (3, 7)
    assert strides == {1, 2}   # stride drawn from 1..skip


def test_train_sampler_review_cycle():
    from rslo_tpu.data.loader import TrainSampler
    # n=8, review_cycle=0.5 -> block=4: stream is B0 B0 B1 B1 ...
    s = iter(TrainSampler(8, 100, 1, seed=3, review_cycle=0.5))
    got = [next(s) for _ in range(16)]
    assert got[0:4] == got[4:8]          # block repeated
    assert got[8:12] == got[12:16]
    assert got[0:4] != got[8:12]         # next block differs
    # underlying stream still covers the whole epoch across blocks
    assert sorted(got[0:4] + got[8:12]) == list(range(8))
    # resume equivalence mid-repeat
    s2 = iter(TrainSampler(8, 100, 1, seed=3, review_cycle=0.5,
                           last_iter=5))
    assert [next(s2) for _ in range(4)] == got[6:10]


def test_workload_configs_roundtrip():
    """The committed workload configs load through the CLI --config path
    and carry the reference-deployed values (SURVEY.md §2.9)."""
    import pathlib
    from rslo_tpu.cli import _load_cfg
    root = pathlib.Path(__file__).resolve().parents[1]
    tr = _load_cfg(str(root / "configs" / "kitti_train_ours.json"))
    assert tr.voxelizer.point_cloud_range == (-70.4, -38.4, -3.0,
                                              70.4, 38.4, 5.0)
    assert tr.voxelizer.voxel_size == (0.1, 0.1, 0.2)
    assert tr.voxelizer.max_points_per_voxel == 10
    assert tr.middle.name == "SparseMiddleCov"
    assert tr.odom.bn_type == "sync_bn"
    assert tr.odom.layer_nums == (3, 5, 5)
    assert tr.loss.penalize_ratio == 0.97
    assert tr.loss.reg_weight == 0.005
    assert tr.optimizer.lr_max == 8.0e-4
    assert tr.train.steps == 200000
    assert tr.data.seq_length == 3
    ev = _load_cfg(str(root / "configs" / "kitti_eval_ours.json"))
    assert ev.data.seq_length == 2 and not ev.data.random_flip_y
    # round-trip stability
    from rslo_tpu.config.schema import PipelineCfg
    assert PipelineCfg.from_json(tr.to_json()) == tr


def test_quantized_transfer_roundtrip(rng):
    """int16 transfer quantization: sub-resolution round-trip error and
    a collate that emits int16 + a prepare_example that dequantizes to
    (near-)identical voxel features."""
    import jax.numpy as jnp
    from rslo_tpu.data.loader import (QUANT_POS_SCALE, QUANT_UNIT_SCALE,
                                      quantize_points)
    from rslo_tpu.data.prepare import dequantize_points
    pts = rng.normal(size=(200, 7)).astype(np.float32)
    pts[:, :3] *= 30.0
    pts[:, 3:] = np.clip(pts[:, 3:], -1, 1)
    q = quantize_points(pts)
    assert q.dtype == np.int16
    back = np.asarray(dequantize_points(jnp.asarray(q)))
    assert np.abs(back[:, :3] - pts[:, :3]).max() <= QUANT_POS_SCALE
    assert np.abs(back[:, 3:] - pts[:, 3:]).max() <= QUANT_UNIT_SCALE

    cfg = DataCfg(max_points=128, quantize_transfer=True)
    samples = [{"points": [pts[:100], pts[100:]],
                "odometry": np.zeros((1, 7), np.float32),
                "seq": 0, "frames": (0, 1)}]
    batch = collate(samples, cfg)
    assert batch["points"].dtype == np.int16

    # dequantized points produce the same voxel set and ~same features
    from rslo_tpu.data.prepare import prepare_example
    from rslo_tpu.ops.voxelize import VoxelizerConfig
    vcfg = VoxelizerConfig(point_cloud_range=(-40, -40, -3, 40, 40, 5),
                           voxel_size=(0.5, 0.5, 0.5), max_points=10,
                           max_voxels=256)
    exq = prepare_example(jnp.asarray(batch["points"][0]),
                          jnp.asarray(batch["point_mask"][0]), vcfg,
                          mean_mode=True)
    pf = np.zeros((2, 128, 7), np.float32)
    pf[0, :100], pf[1, :100] = pts[:100], pts[100:]
    exf = prepare_example(jnp.asarray(pf),
                          jnp.asarray(batch["point_mask"][0]), vcfg,
                          mean_mode=True)
    # voxel coords may differ only for points within quantization
    # distance of a cell boundary; at 0.5 m cells vs 3.9 mm rounding,
    # require near-total agreement
    ca = np.asarray(exq["coords"])
    cb = np.asarray(exf["coords"])
    same = (ca == cb).all(-1)
    assert same.mean() > 0.98
    fa = np.asarray(exq["voxel_features"])[same]
    fb = np.asarray(exf["voxel_features"])[same]
    np.testing.assert_allclose(fa, fb, atol=5e-3)
