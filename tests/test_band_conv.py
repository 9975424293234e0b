"""Banded one-hot gather engine (ops/band_conv.py) correctness.

The banded plan must reproduce the plain rulebook gather-matmul conv
exactly (fp32 compute) including the overflow path, and the full
SparseMiddleCov under engine="band" must match engine="rulebook" to
bf16 rounding.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rslo_tpu.config.schema import MiddleCfg
from rslo_tpu.models.middle import (SparseMiddleCov, build_band_geometry,
                                    build_geometry)
from rslo_tpu.ops import band_conv as bc
from rslo_tpu.ops import sparse_conv as sc

GRID = (9, 32, 32)
CAPS = (1024, 1024, 512, 256)


def _level(rng, n=400, pad=112):
    nz, ny, nx = GRID
    ids = np.sort(rng.choice(nz * ny * nx, size=n, replace=False))
    z = ids // (ny * nx)
    y = (ids // nx) % ny
    x = ids % nx
    coords = np.concatenate([np.stack([z, y, x], -1),
                             np.full((pad, 3), -1)]).astype(np.int32)
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return sc.with_slot_map(
        sc.level_from_coords(jnp.asarray(coords), jnp.asarray(mask),
                             GRID))


def test_band_matches_rulebook_fp32():
    rng = np.random.default_rng(0)
    lvl = _level(rng)
    rb = sc.build_submanifold_index(lvl)
    V = lvl.capacity
    feats = jnp.asarray(rng.normal(size=(V, 8)).astype(np.float32))
    feats = jnp.where(lvl.mask[:, None], feats, 0.0)
    w = jnp.asarray(rng.normal(size=(27, 8, 16)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(16,)).astype(np.float32))

    ref = sc.sparse_conv_apply(feats, rb, w, b, lvl.mask)
    band = bc.build_band_index(rb, V, block=64, window=192)
    out = bc.band_conv_apply(feats, band, w, b, lvl.mask,
                             compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_band_overflow_path_exact():
    """A deliberately tiny window forces most pairs through the
    overflow list — the result must still be exact."""
    rng = np.random.default_rng(1)
    lvl = _level(rng)
    rb = sc.build_submanifold_index(lvl)
    V = lvl.capacity
    n_valid = int(np.asarray(rb.valid).sum())
    feats = jnp.asarray(rng.normal(size=(V, 4)).astype(np.float32))
    feats = jnp.where(lvl.mask[:, None], feats, 0.0)
    w = jnp.asarray(rng.normal(size=(27, 4, 8)).astype(np.float32))

    ref = sc.sparse_conv_apply(feats, rb, w, None, lvl.mask)
    band = bc.build_band_index(rb, V, block=64, window=8,
                               ov_capacity=n_valid + 64)
    n_ov = int(np.asarray((band.ov_out < band.sel.shape[0] *
                           band.sel.shape[2]).sum()))
    assert n_ov > 100           # the tiny window really overflowed
    out = bc.band_conv_apply(feats, band, w, None, lvl.mask,
                             compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_band_engine_matches_rulebook_middle():
    rng = np.random.default_rng(2)
    nz, ny, nx = 41, 64, 64
    grid = (nz, ny, nx)
    caps = (2048, 3072, 2048, 1024)
    n, pad = 1200, 150
    ids = np.sort(rng.choice(nz * ny * nx, size=n, replace=False))
    z = ids // (ny * nx)
    y = (ids // nx) % ny
    x = ids % nx
    coords = jnp.asarray(np.concatenate(
        [np.stack([z, y, x], -1), np.full((pad, 3), -1)]).astype(np.int32))
    mask = jnp.asarray(np.concatenate([np.ones(n, bool),
                                       np.zeros(pad, bool)]))
    feats = rng.normal(size=(n + pad, 7)).astype(np.float32)
    feats[n:] = 0
    feats = jnp.asarray(feats)

    cfg = MiddleCfg(bn_type="none", channels=(8, 8, 16, 16),
                    level_capacities=caps, remat=False)
    net = SparseMiddleCov(cfg)
    geo_rb = build_geometry(coords, mask, grid, caps)
    geo_bd = build_band_geometry(coords, mask, grid, caps,
                                 windows=(192, 512, 320), block=128)
    variables = net.init(jax.random.PRNGKey(0), feats, geo_rb, False)
    bev_a, cov_a = net.apply(variables, feats, geo_rb, False)
    bev_b, cov_b = net.apply(variables, feats, geo_bd, False)
    np.testing.assert_allclose(np.asarray(bev_b), np.asarray(bev_a),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(cov_b), np.asarray(cov_a),
                               rtol=2e-2, atol=2e-2)


def test_band_gradients_finite():
    rng = np.random.default_rng(3)
    lvl = _level(rng, n=200, pad=56)
    rb = sc.build_submanifold_index(lvl)
    V = lvl.capacity
    feats = jnp.asarray(rng.normal(size=(V, 4)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(27, 4, 8)).astype(np.float32))
    band = bc.build_band_index(rb, V, block=64, window=160)

    def loss(w, f):
        return jnp.sum(bc.band_conv_apply(f, band, w, None,
                                          lvl.mask) ** 2)

    gw, gf = jax.grad(loss, argnums=(0, 1))(w, feats)
    assert np.isfinite(np.asarray(gw)).all()
    assert np.isfinite(np.asarray(gf)).all()


@pytest.mark.slow
def test_band_engine_through_net():
    """OdomNet with middle.engine="band" must agree with the rulebook
    engine through the full forward (same params)."""
    import sys
    sys.path.insert(0, "tests")
    import dataclasses
    from test_model import tiny_cfg, make_example
    from rslo_tpu.models.net import OdomNet

    cfg = tiny_cfg()
    rng = np.random.default_rng(0)
    ex = make_example(rng, cfg, L=2)
    net_a = OdomNet(cfg)
    variables = net_a.init(jax.random.PRNGKey(0), ex, train=False)
    out_a = net_a.apply(variables, ex, train=False)["odometry"]
    cfg_b = cfg.replace(middle=dataclasses.replace(
        cfg.middle, engine="band", band_block=128,
        band_windows=(256, 640, 384)))
    out_b = OdomNet(cfg_b).apply(variables, ex, train=False)["odometry"]
    np.testing.assert_allclose(np.asarray(out_b), np.asarray(out_a),
                               rtol=2e-2, atol=2e-2)


def test_overflow_counter_and_saturation_guard(monkeypatch):
    """ov_count counts ALL valid-but-out-of-window pairs; when it
    exceeds the plan's storage capacity the documented-inexact path is
    active and must be detectable."""
    import pytest
    rng = np.random.default_rng(5)
    lvl = _level(rng)
    rb = sc.build_submanifold_index(lvl)
    V = lvl.capacity
    n_valid = int(np.asarray(rb.valid).sum())

    # roomy capacity: counter == stored overflow pairs, not saturated
    band = bc.build_band_index(rb, V, block=64, window=8,
                               ov_capacity=n_valid + 64)
    Vp = band.sel.shape[0] * band.sel.shape[2]
    stored = int(np.asarray((band.ov_out < Vp).sum()))
    assert int(np.asarray(band.ov_count)) == stored > 100
    assert not bool(np.asarray(bc.overflow_saturated(band)))

    # tiny capacity: pairs dropped -> saturated flag + env-gated raise
    sat = bc.build_band_index(rb, V, block=64, window=8, ov_capacity=16)
    assert int(np.asarray(sat.ov_count)) > 16
    assert bool(np.asarray(bc.overflow_saturated(sat)))

    feats = jnp.asarray(rng.normal(size=(V, 4)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(27, 4, 8)).astype(np.float32))
    monkeypatch.setenv("RSLO_BAND_CHECK", "1")
    with pytest.raises(Exception, match="saturated"):
        np.asarray(bc.band_conv_apply(feats, sat, w, None, lvl.mask,
                                      compute_dtype=jnp.float32))
    # the exact plan passes the guard
    np.asarray(bc.band_conv_apply(feats, band, w, None, lvl.mask,
                                  compute_dtype=jnp.float32))


def test_band_dispatch_mixed_engine():
    """Per-level dispatch (min_channels): narrow rulebooks stay raw
    ConvIndex (XLA row gathers), wide ones get band plans — and the
    mixed geometry reproduces the all-rulebook middle exactly."""
    rng = np.random.default_rng(6)
    nz, ny, nx = 41, 64, 64
    grid = (nz, ny, nx)
    caps = (2048, 3072, 2048, 1024)
    n, pad = 1200, 150
    ids = np.sort(rng.choice(nz * ny * nx, size=n, replace=False))
    coords = jnp.asarray(np.concatenate(
        [np.stack([ids // (ny * nx), (ids // nx) % ny, ids % nx], -1),
         np.full((pad, 3), -1)]).astype(np.int32))
    mask = jnp.asarray(np.concatenate([np.ones(n, bool),
                                       np.zeros(pad, bool)]))
    feats = rng.normal(size=(n + pad, 7)).astype(np.float32)
    feats[n:] = 0
    feats = jnp.asarray(feats)

    channels = (8, 8, 16, 16)
    geo_mix = build_band_geometry(coords, mask, grid, caps,
                                  windows=(192, 512, 320), block=128,
                                  channels=channels, min_channels=16)
    # widest conv widths: sub (8,8,16,16); down (8,16,16,16); inv (16,8)
    assert isinstance(geo_mix.sub_rb[0], sc.ConvIndex)
    assert isinstance(geo_mix.sub_rb[1], sc.ConvIndex)
    assert isinstance(geo_mix.sub_rb[2], bc.BandIndex)
    assert isinstance(geo_mix.sub_rb[3], bc.BandIndex)
    assert isinstance(geo_mix.down_rb[0], sc.ConvIndex)
    assert all(isinstance(r, bc.BandIndex) for r in geo_mix.down_rb[1:])
    assert isinstance(geo_mix.inv_rb[0], bc.BandIndex)
    assert isinstance(geo_mix.inv_rb[1], sc.ConvIndex)

    cfg = MiddleCfg(bn_type="none", channels=channels,
                    level_capacities=caps, remat=False)
    net = SparseMiddleCov(cfg)
    geo_rb = build_geometry(coords, mask, grid, caps)
    variables = net.init(jax.random.PRNGKey(0), feats, geo_rb, False)
    bev_a, cov_a = net.apply(variables, feats, geo_rb, False)
    bev_b, cov_b = net.apply(variables, feats, geo_mix, False)
    np.testing.assert_allclose(np.asarray(bev_b), np.asarray(bev_a),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(cov_b), np.asarray(cov_a),
                               rtol=2e-2, atol=2e-2)


def test_band_overflow_within_capacity_deployed_shapes():
    """At the DEPLOYED KITTI-scale shapes (real sparse_shape, committed
    band_windows/caps, 131k-point frame) no plan may come near overflow
    saturation — the guard that keeps the documented-inexact dropped-
    pair path from silently activating in production."""
    from rslo_tpu.config.schema import PipelineCfg, grid_size
    from rslo_tpu.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu.models.middle import band_overflow_counts
    from rslo_tpu.utils.synthetic import synth_sequence

    cfg = PipelineCfg()
    vcfg = voxelizer_config(cfg)
    nx, ny, nz = grid_size(cfg.voxelizer)
    sparse_shape = (nz + 1, ny, nx)
    frames, _ = synth_sequence(seed=0, n_frames=1,
                               n_points=cfg.data.max_points)
    pts = jnp.asarray(frames[0][None])
    msk = jnp.ones((1, pts.shape[1]), bool)
    ex = jax.jit(lambda p, m: prepare_example(p, m, vcfg,
                                              mean_mode=True))(pts, msk)
    # min_channels=0: wrap EVERY rulebook so all 10 plans get audited
    geo = jax.jit(lambda c, m: build_band_geometry(
        c, m, sparse_shape, cfg.middle.level_capacities,
        windows=tuple(cfg.middle.band_windows),
        block=cfg.middle.band_block))(ex["coords"][0],
                                      ex["voxel_mask"][0])
    counts = band_overflow_counts(geo)
    assert len(counts) == 10
    for name, (cnt, cap) in counts.items():
        c = int(np.asarray(cnt))
        assert c <= cap // 2, (
            f"band plan {name}: {c} overflow pairs vs capacity {cap} — "
            f"window widths no longer cover the deployed geometry")


@pytest.mark.slow
def test_band_engine_train_step_finite():
    """One full self-supervised train step with middle.engine='band'
    (the matched-budget sparse training config) must produce finite
    loss and gradients."""
    import dataclasses
    import sys
    sys.path.insert(0, "tests")
    from test_model import tiny_cfg
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.train.optim import build_optimizer
    from rslo_tpu.train.state import TrainState
    from rslo_tpu.train.step import make_train_step
    from rslo_tpu.utils.synthetic import synth_sequence
    from rslo_tpu.data.prepare import prepare_example, voxelizer_config

    cfg = tiny_cfg()
    cfg = cfg.replace(middle=dataclasses.replace(
        cfg.middle, name="SparseMiddleCov", engine="band", remat=False))
    net = OdomNet(cfg)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    frames, gts = synth_sequence(seed=1, n_frames=2, n_points=3000)
    pts = np.stack(frames)
    scale = 6.0 / 60.0
    pts[:, :, :2] *= scale
    pts[:, :, 2] = np.clip(pts[:, :, 2] * 0.2, -0.79, 0.79)
    gt = gts[:1].copy()
    gt[:, :3] *= scale
    raw = {"points": jnp.asarray(pts),
           "point_mask": jnp.ones((2, pts.shape[1]), bool),
           "odometry": jnp.asarray(gt)}
    batch = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), raw)
    batch = jax.device_put(batch, NamedSharding(mesh, P("data")))

    ex = prepare_example(raw["points"], raw["point_mask"],
                         voxelizer_config(cfg))
    ex["odometry"] = raw["odometry"]
    variables = net.init(jax.random.PRNGKey(0), ex, train=False)
    tx = build_optimizer(cfg.optimizer, cfg.train)
    state = TrainState.create(variables, tx, {"rot": 0.0, "trans": 0.0})
    state = jax.device_put(state, NamedSharding(mesh, P()))

    step = make_train_step(net, tx, cfg, mesh, warmup=True,
                           self_supervised=True)
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])), m
    leaves = jax.tree.leaves(state.params)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
