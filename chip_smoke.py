"""Run the main path once on the GPU and check what comes out.

    python chip_smoke.py             # one card, all phases below
    python chip_smoke.py --cards 4   # four cards: the multi-card paths only

One process drives the card(s).  The phases run in order and the first
failure ends the run with a traceback and a non-zero exit code:

  1. device   a GPU must be present (no CPU fallback); prints the JAX
              version, the device kind and the card's name and power
              limit as nvidia-smi reports them.
  2. kernel   the chamfer NN kernel (ops/chamfer.py) against its plain
              references at the loss's width.
  3. islands  float32 functions jitted on the GPU and on the CPU of this
              process, on the same inputs.
  4. train    ``cli train --synthetic --steps 4`` with
              configs/kitti_train_ours.json (SparseMiddleCov) and with
              the same file set to PillarMiddleCov; the checkpoint must
              restore.
  5. refine   ``cli evaluate --synthetic --refine --max_windows 8`` on
              the pillar model.
  6. stream   16 frames through ``StreamingOdometry.push``.
  7. steady   one train step after warm-up from the trained pillar state.

With ``--cards 4``: the data-parallel train step, the spatial- and the
tensor-parallel forwards of the pillar model, each on four cards against
one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TRAIN_CONFIG = ROOT / "configs" / "kitti_train_ours.json"
SEED = 0
NN_POINTS = 20480        # the loss's max_loss_points
MISALIGNED = (20000, 19999)   # sizes that fit no kernel block
ORACLE_ROWS = 2048       # rows of the float64 brute-force check
STREAM_FRAMES = 16
CARD = ""                # nvidia-smi name and power limit, for the logs


def log(msg: str):
    print(msg, flush=True)


def check(ok, msg: str):
    if not ok:
        raise AssertionError(msg)


def timed(name: str, t0: float):
    log(f"[time] {name}: {time.perf_counter() - t0:.3f} s on {CARD}")


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, jax.device_get(tree))


# ---- 1. device -----------------------------------------------------------

def phase_device(cards: int):
    global CARD
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found only "
                 f"{devs[0].platform} devices")
    check(len(devs) >= cards, f"need {cards} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    CARD = smi[0]
    log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}")
    for line in smi:
        log(f"nvidia-smi: {line}")
    sys.path.insert(0, str(ROOT))
    import rslo_tpu.utils.jax_cache  # noqa: F401  (persistent cache)
    return devs


# ---- 2. kernel parity ----------------------------------------------------

def _top2_exact(src, tgt, tgt_mask, block: int = 1024):
    """(N, 2) smallest and second-smallest squared distances, by exact
    coordinate differences in float32 on the default device."""
    import jax
    import jax.numpy as jnp
    n = src.shape[0]
    pad = (-n) % block
    s = jnp.pad(jnp.asarray(src), ((0, pad), (0, 0)))
    pen = jnp.where(jnp.asarray(tgt_mask), 0.0, jnp.inf)
    t = jnp.asarray(tgt)

    def rows(sb):
        d = jnp.sum((sb[:, None, :] - t[None]) ** 2, axis=-1) + pen
        return -jax.lax.top_k(-d, 2)[0]

    out = jax.jit(lambda s: jax.lax.map(rows, s.reshape(-1, block, 3)))(s)
    return np.asarray(out).reshape(-1, 2)[:n]


def _oracle64(src, tgt, tgt_mask, rows):
    """float64 brute force for the given source rows: (dist, first
    index of the minimum)."""
    s = src[rows].astype(np.float64)
    t = tgt.astype(np.float64)
    d = np.empty((len(rows), len(t)))
    for i in range(0, len(rows), 256):
        d[i:i + 256] = ((s[i:i + 256, None, :] - t[None]) ** 2).sum(-1)
    d[:, ~tgt_mask] = np.inf
    idx = d.argmin(1)                  # argmin returns the first minimum
    return d[np.arange(len(rows)), idx], idx


def _ms(f, reps: int = 20) -> float:
    import jax
    jax.block_until_ready(f())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_kernel():
    import jax
    import jax.numpy as jnp
    from rslo_tpu.ops.chamfer import nn_search, nn_search_pallas
    from rslo_tpu.utils.synthetic import synth_sequence

    # two consecutive synthetic scans, cropped to the KITTI config's
    # point-cloud range as the loss sees them
    frames, _ = synth_sequence(seed=SEED, n_frames=2,
                               n_points=2 * NN_POINTS)
    lo, hi = np.array([-70.4, -38.4, -3.0]), np.array([70.4, 38.4, 5.0])
    src, tgt = [f[np.all((f[:, :3] > lo) & (f[:, :3] < hi), 1), :3]
                [:NN_POINTS] for f in frames]
    check(len(src) == len(tgt) == NN_POINTS, "too few points in range")
    rng = np.random.default_rng(SEED)
    cases = [
        ("aligned", src, np.ones(len(src), bool), tgt,
         np.ones(len(tgt), bool)),
        # a quarter of the targets masked
        ("misaligned", src[:MISALIGNED[0]], np.ones(MISALIGNED[0], bool),
         tgt[:MISALIGNED[1]], rng.random(MISALIGNED[1]) >= 0.25),
    ]
    kernel = jax.jit(nn_search_pallas)
    for name, s, sm, t, tm in cases:
        args = [jnp.asarray(a) for a in (s, sm, t, tm)]
        d_k, i_k = _np(kernel(*args))
        with jax.default_matmul_precision("highest"):
            d_r, i_r = _np(nn_search(*args))
        check(np.all(np.isfinite(d_k)) and d_k.shape == (len(s),),
              f"{name}: kernel output not finite or misshaped")
        # Distances.  The reference's cross-term form |s|^2 - 2 s.t +
        # |t|^2 rounds each term, losing up to ~8 * 2^-24 * (|s|^2 +
        # |t|^2) to cancellation (~5e-3 m^2 for two points at 70 m,
        # above the flat 1e-3); the kernel takes exact differences.
        ref_err = 8 * 2.0 ** -24 * (np.sum(s * s, -1) +
                                    np.sum(t[i_r] * t[i_r], -1))
        tol = 1e-3 + 1e-5 * np.abs(d_r) + ref_err
        err = np.abs(d_k - d_r)
        check(np.all(err <= tol),
              f"{name}: distance off by {err.max():.3e} m^2")
        # Indices: equal wherever the best and second-best candidates
        # are further apart than that tolerance.
        top2 = _top2_exact(s, t, tm)
        sure = (top2[:, 1] - top2[:, 0]) > tol
        bad = np.sum(i_k[sure] != i_r[sure])
        check(bad == 0, f"{name}: {bad} indices differ from nn_search")
        # float64 brute force on sampled rows: equal indices (the first
        # index at exact ties, as the kernel's rule says).
        rows = rng.choice(len(s), ORACLE_ROWS, replace=False)
        od, oi = _oracle64(s, t, tm, rows)
        bad = np.sum(i_k[rows] != oi)
        check(bad == 0, f"{name}: {bad} indices differ from float64")
        check(np.allclose(d_k[rows], od, rtol=1e-5, atol=1e-5),
              f"{name}: distances differ from float64")
        log(f"kernel {name} {len(s)}x{len(t)}: ok (max |d - d_ref| "
            f"{err.max():.2e} m^2, {np.sum(~sure)} near-ties skipped, "
            f"{ORACLE_ROWS} float64 rows equal)")

    a = [jnp.asarray(x) for x in cases[0][1:]]
    b = [jnp.stack([x] * 3) for x in a]
    for label, f in (("nn_search (XLA)", nn_search),
                     ("nn_search_pallas", nn_search_pallas)):
        f1, f3 = jax.jit(f), jax.jit(jax.vmap(f))
        one = _ms(lambda: f1(*a))
        three = _ms(lambda: f3(*b))
        log(f"[time] {label} {NN_POINTS}x{NN_POINTS}: {one:.4f} ms, "
            f"3 pairs under vmap: {three:.4f} ms on {CARD}")


# ---- 3. float32 islands, GPU against CPU ---------------------------------

def _gpu_and_cpu(f, *args):
    import jax
    g = jax.jit(f)
    out_gpu = _np(g(*args))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        out_cpu = _np(g(*jax.device_put(args, cpu)))
    return out_gpu, out_cpu


def _rot(rng, yaw_deg: float, tilt_deg: float):
    from scipy.spatial.transform import Rotation
    ang = np.deg2rad([rng.uniform(-tilt_deg, tilt_deg),
                      rng.uniform(-tilt_deg, tilt_deg),
                      rng.uniform(-yaw_deg, yaw_deg)])
    return Rotation.from_euler("xyz", ang).as_matrix().astype(np.float32)


def phase_islands():
    import jax.numpy as jnp
    from rslo_tpu import geometry as G
    from rslo_tpu.geometry.kabsch import weighted_kabsch
    from rslo_tpu.losses.consistency import consistency_loss_pairs
    from rslo_tpu.pgo.pose_graph import chain_graph, optimize_pose_graph
    from rslo_tpu.utils.synthetic import synth_sequence

    rng = np.random.default_rng(SEED)
    frames, _ = synth_sequence(seed=SEED + 1, n_frames=3,
                               n_points=NN_POINTS)

    # weighted Kabsch (jnp.linalg.svd: cuSOLVER on the GPU, LAPACK on
    # the CPU).  Tolerances: float32 sums over 20480 weighted products
    # in another order plus another SVD; t carries R's error times the
    # ~30 m centroid.
    tgt = np.stack([f[:, :3] for f in frames])
    Rs = np.stack([_rot(rng, 10.0, 2.0) for _ in frames])
    ts = rng.normal(0, 1.0, (3, 3)).astype(np.float32)
    src = (np.einsum("bij,bnj->bni", Rs, tgt) + ts[:, None] +
           rng.normal(0, 0.02, tgt.shape)).astype(np.float32)
    w = rng.uniform(0, 1, tgt.shape[:2]).astype(np.float32)
    (Rg, tg), (Rc, tc) = _gpu_and_cpu(weighted_kabsch, src, tgt, w)
    check(np.allclose(Rg, Rc, atol=1e-4), "Kabsch R: GPU vs CPU")
    check(np.allclose(tg, tc, atol=1e-3), "Kabsch t: GPU vs CPU")
    check(np.allclose(Rg, Rs, atol=1e-3), "Kabsch R: vs truth")
    log(f"kabsch: ok (|R_gpu - R_cpu| {np.abs(Rg - Rc).max():.2e}, "
        f"|t_gpu - t_cpu| {np.abs(tg - tc).max():.2e} m)")

    # consistency loss at a known offset: tgt = the same scan moved by
    # a 1 degree yaw and 0.3 m.  The GPU searches with the Pallas
    # kernel, the CPU with the XLA scan; a few near-tie associations
    # may differ, which moves the loss in the 4th digit and, through the
    # re-associating inner ICP, the correction by up to millimetres
    # (0.8 mm measured on an H100).
    pts = np.stack([f[:, :3] for f in frames])
    nrm = np.stack([f[:, 4:7] for f in frames])
    R_off = np.stack([_rot(rng, 1.0, 0.0) for _ in frames])
    moved = (np.einsum("bij,bnj->bni", R_off, pts) +
             np.array([0.3, 0.0, 0.0], np.float32) +
             rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[:, -100:] = False
    cov = rng.normal(0, 0.3, pts.shape[:2] + (7,)).astype(np.float32)
    cov[..., :3] = np.abs(cov[..., :3]) + 0.05
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 3, 3))
    zero = np.zeros((3, 3), np.float32)

    def loss(pts, mask, nrm, cov, moved):
        return consistency_loss_pairs(
            pts, mask, nrm, cov, moved, mask, cov, eye, zero,
            penalize_ratio=0.97, reg_weight=0.005, icp_iter=2)

    (lg, Rg, tg), (lc, Rc, tc) = _gpu_and_cpu(loss, pts, mask, nrm, cov,
                                              moved)
    check(np.isfinite(lg) and np.isfinite(lc), "consistency: not finite")
    check(abs(lg - lc) <= 1e-3 * abs(lc), f"consistency loss {lg} vs {lc}")
    check(np.allclose(Rg, Rc, atol=1e-4), "consistency res_R: GPU vs CPU")
    check(np.allclose(tg, tc, atol=5e-3), "consistency res_t: GPU vs CPU")
    log(f"consistency: ok (loss gpu {lg:.6f} cpu {lc:.6f}, "
        f"|res_t| diff {np.abs(tg - tc).max():.2e} m)")

    # pose graph: a noisy 64-pose loop with one closure edge; dense
    # Cholesky (cuSOLVER vs LAPACK) over ten Gauss-Newton steps.
    n = 64
    ang = 2 * np.pi / n
    gt = np.zeros((n - 1, 7), np.float32)
    gt[:, 0] = 2 * 20.0 * np.sin(ang / 2)
    gt[:, 3], gt[:, 6] = np.cos(ang / 2), np.sin(ang / 2)
    noisy = gt.copy()
    noisy[:, :3] += rng.normal(0, 0.05, (n - 1, 3))
    qn = np.asarray(G.qexp(jnp.asarray(rng.normal(0, 0.005, (n - 1, 3)),
                                       jnp.float32)))
    noisy[:, 3:] = np.asarray(G.qmult(jnp.asarray(noisy[:, 3:]),
                                      jnp.asarray(qn)))
    gt_abs = G.odom_to_abs_pose(np.concatenate([[[0, 0, 0, 1, 0, 0, 0]],
                                                gt]))
    loop = np.asarray(G.np_calc_vo(gt_abs[-1:], gt_abs[:1]), np.float32)
    poses0, graph = chain_graph(
        jnp.asarray(noisy), loop_edges=jnp.asarray([[n - 1, 0]]),
        loop_meas=jnp.asarray(loop.reshape(1, 7)),
        loop_info=jnp.eye(6)[None] * 100.0)

    def pgo(poses0, graph):
        return optimize_pose_graph(poses0, graph, iters=10)

    (pg, cg), (pc, cc) = _gpu_and_cpu(pgo, poses0, graph)
    check(np.all(np.isfinite(pg)), "pose graph: not finite")
    check(np.allclose(pg[:, :3], pc[:, :3], atol=1e-3),
          f"pose graph t: GPU vs CPU {np.abs(pg - pc)[:, :3].max():.2e}")
    check(np.allclose(pg[:, 3:], pc[:, 3:], atol=1e-4),
          "pose graph q: GPU vs CPU")
    check(abs(cg - cc) <= 1e-2 * abs(cc) + 1e-6, f"cost {cg} vs {cc}")
    log(f"pose graph: ok (|p_gpu - p_cpu| {np.abs(pg - pc).max():.2e}, "
        f"cost gpu {cg:.4e} cpu {cc:.4e})")


# ---- 4-6. train, refine, stream ------------------------------------------

def _example0(cfg):
    """The first synthetic training window as ``cli train`` builds it."""
    import jax.numpy as jnp
    from rslo_tpu.cli import _synthetic_dataset
    from rslo_tpu.data.loader import collate
    from rslo_tpu.data.prepare import prepare_example, voxelizer_config
    b0 = collate([_synthetic_dataset(cfg, "train")[0]], cfg.data)
    ex0 = prepare_example(jnp.asarray(b0["points"][0]),
                          jnp.asarray(b0["point_mask"][0]),
                          voxelizer_config(cfg))
    ex0["odometry"] = jnp.asarray(b0["odometry"][0])
    return ex0


def phase_train(cfg_path: Path, model_dir: Path, label: str):
    import jax
    from rslo_tpu.cli import main as cli_main
    from rslo_tpu.config.schema import PipelineCfg
    from rslo_tpu.train.loop import Trainer, data_mesh

    t0 = time.perf_counter()
    cli_main(["train", "--config", str(cfg_path), "--model_dir",
              str(model_dir), "--synthetic", "--steps", "4"])
    timed(f"train {label}: 4 steps incl. compile", t0)
    recs = [json.loads(line) for line in
            (model_dir / "log.json.lst").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    check(losses and all(math.isfinite(x) for x in losses),
          f"{label}: loss {losses}")

    cfg = PipelineCfg.from_json(cfg_path.read_text())
    trainer = Trainer(cfg, str(model_dir), data_mesh())
    ex0 = _example0(cfg)
    state = trainer.init_state(ex0)        # restores the latest step
    check(int(state.step) == 4, f"{label}: restored step {state.step}")
    fresh = trainer.net.init(jax.random.PRNGKey(cfg.train.seed), ex0,
                             train=False)["params"]
    new = _np(state.params)
    check(all(np.all(np.isfinite(x)) for x in jax.tree.leaves(new)),
          f"{label}: non-finite parameters")
    moved = sum(not np.array_equal(a, b) for a, b in
                zip(jax.tree.leaves(new), jax.tree.leaves(_np(fresh))))
    check(moved > 0, f"{label}: parameters did not change")
    log(f"train {label}: ok (loss {losses}, {moved} of "
        f"{len(jax.tree.leaves(new))} parameter arrays changed, "
        f"checkpoint restored at step 4)")
    return cfg, trainer, state


def phase_refine(cfg_path: Path, model_dir: Path):
    from rslo_tpu.cli import main as cli_main
    t0 = time.perf_counter()
    cli_main(["evaluate", "--config", str(cfg_path), "--model_dir",
              str(model_dir), "--synthetic", "--refine",
              "--max_windows", "8"])
    timed("evaluate --refine (8 windows) incl. compile", t0)
    res = json.loads((model_dir / "eval_results.json").read_text())
    seqs = [k for k in res if k.startswith("seq_")]
    check(seqs, f"refine: no sequence results in {list(res)}")
    nums = list(_numbers({k: res[k] for k in seqs}))
    check(nums and all(math.isfinite(x) for x in nums),
          f"refine: non-finite metrics in {res}")
    log(f"refine: ok ({len(nums)} finite numbers; "
        f"{json.dumps(res[seqs[0]])})")


def _numbers(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _numbers(x)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield float(tree)


def phase_stream(cfg, trainer, state):
    import jax
    import jax.numpy as jnp
    from rslo_tpu.data.prepare import (mean_vfe_ok, prepare_example,
                                       voxelizer_config)
    from rslo_tpu.eval.streaming import StreamingOdometry
    from rslo_tpu.utils.synthetic import synth_sequence

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    frames, _ = synth_sequence(seed=SEED + 2, n_frames=STREAM_FRAMES,
                               n_points=cfg.data.max_points)
    so = StreamingOdometry(trainer.net, variables, cfg)
    t0 = time.perf_counter()
    poses = [np.array(so.push(f)) for f in frames[:2]]
    timed("stream: first 2 frames incl. compile", t0)
    t0 = time.perf_counter()
    poses += [np.array(so.push(f)) for f in frames[2:]]
    timed(f"stream: next {STREAM_FRAMES - 2} frames", t0)
    poses = np.stack(poses)
    check(poses.shape == (STREAM_FRAMES, 7) and np.all(np.isfinite(poses)),
          f"stream: poses {poses.shape} not finite")

    # the same pair through the stateless two-frame forward; the pose
    # after frame 1 is that pair's odometry.  Both run the same bf16
    # convolutions on the same inputs, compiled in two programs.
    ex = prepare_example(jnp.asarray(np.stack(frames[:2])),
                         jnp.ones((2, frames[0].shape[0]), bool),
                         voxelizer_config(cfg), mean_mode=mean_vfe_ok(cfg))
    odom = np.asarray(jax.jit(
        lambda v, e: trainer.net.apply(v, e, train=False)["odometry"][0])(
            variables, ex))
    dt = np.abs(poses[1, :3] - odom[:3]).max()
    dq = 1.0 - abs(float(np.dot(poses[1, 3:], odom[3:])))
    check(dt <= 1e-3, f"stream vs two-frame forward: |dt| {dt:.2e} m")
    check(dq <= 1e-6, f"stream vs two-frame forward: 1-|q.q'| {dq:.2e}")
    log(f"stream: ok ({STREAM_FRAMES} finite poses; pair 0->1 matches "
        f"the two-frame forward: |dt| {dt:.2e} m, 1-|q.q'| {dq:.2e})")


def _pillar_config() -> dict:
    """The committed config with only ``middle.name`` changed."""
    cfg = json.loads(TRAIN_CONFIG.read_text())
    cfg["middle"]["name"] = "PillarMiddleCov"
    return cfg


def phase_steady(cfg, trainer, state):
    """One steady-phase train step (after warm-up: the loss warps the
    clouds by the predicted motion) from the trained state."""
    import jax
    from rslo_tpu.cli import _synthetic_dataset
    from rslo_tpu.data.loader import collate
    from rslo_tpu.train.loop import shard_batch
    from rslo_tpu.train.step import make_train_step
    b = collate([_synthetic_dataset(cfg, "train")[0]], cfg.data)
    b.pop("meta", None)
    step = make_train_step(trainer.net, trainer.tx, cfg, trainer.mesh,
                           warmup=False)
    t0 = time.perf_counter()
    new, m = step(state, shard_batch(b, trainer.mesh))
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    timed("steady train step incl. compile", t0)
    check(math.isfinite(loss) and math.isfinite(gn),
          f"steady step: loss {loss}, grad norm {gn}")
    check(all(np.all(np.isfinite(x)) for x in jax.tree.leaves(
        _np(new.params))), "steady step: non-finite parameters")
    log(f"steady: ok (loss {loss:.4f}, grad norm {gn:.4e}, parameters "
        f"finite)")


def one_card():
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        phase_kernel()
        timed("phase kernel", t0)
        t0 = time.perf_counter()
        phase_islands()
        timed("phase islands", t0)

        phase_train(TRAIN_CONFIG, tmp / "sparse", "SparseMiddleCov")
        pillar_cfg = tmp / "pillar.json"
        pillar_cfg.write_text(json.dumps(_pillar_config(), indent=1))
        cfg, trainer, state = phase_train(pillar_cfg, tmp / "pillar",
                                          "PillarMiddleCov")
        phase_refine(pillar_cfg, tmp / "pillar")
        phase_stream(cfg, trainer, state)
        phase_steady(cfg, trainer, state)     # donates the state


# ---- four cards ----------------------------------------------------------

def _collectives(compiled) -> list:
    """Cross-device collectives in a compiled program's optimized HLO."""
    text = compiled.as_text()
    return [op for op in ("all-reduce", "all-gather", "reduce-scatter",
                          "collective-permute", "all-to-all") if op in text]


def _norms(leaves):
    return np.array([float(np.linalg.norm(x)) for x in leaves])


def four_cards(devs):
    """DP train step, SP and TP forwards on four cards against one card,
    with the pillar model at full width: the three paths do not depend
    on the middle, and its train step compiles in about half the time of
    SparseMiddleCov's.  Every comparison is made and logged before any
    is checked."""
    import jax
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from rslo_tpu.cli import _synthetic_dataset
    from rslo_tpu.config.schema import PipelineCfg
    from rslo_tpu.data.loader import collate
    from rslo_tpu.models.net import OdomNet
    from rslo_tpu.parallel.spatial import make_spatial_forward
    from rslo_tpu.parallel.tensor import make_model_forward
    from rslo_tpu.train.state import TrainState
    from rslo_tpu.train.step import make_train_step

    cfg = PipelineCfg.from_json(json.dumps(_pillar_config()))
    net = OdomNet(cfg)
    # SGD with lr 1: the update is minus the mean gradient itself, so a
    # wrong sign, scale or sample shows in the updated parameters (Adam's
    # first update is about +-lr whatever the gradient and hides it).
    tx = optax.sgd(1.0)
    b0 = collate([_synthetic_dataset(cfg, "train")[0]], cfg.data)
    sample = {k: b0[k][0] for k in ("points", "point_mask", "odometry")}
    ex0 = _example0(cfg)
    t0 = time.perf_counter()
    variables = _np(jax.jit(lambda r, e: net.init(r, e, train=False))(
        jax.random.PRNGKey(cfg.train.seed), ex0))
    timed("init (jit)", t0)
    state0 = _np(TrainState.create(
        variables, tx, {"rot": cfg.loss.rotation_init_alpha,
                        "trans": cfg.loss.translation_init_alpha}))
    before = jax.tree.leaves((state0.params, state0.alphas))

    def dp_step(n):
        """One train step over n cards, the same sample on each, run
        twice from the same state; returns the updates and losses."""
        mesh = Mesh(np.array(devs[:n]), ("data",))
        batch = jax.device_put(
            jax.tree.map(lambda x: np.broadcast_to(x[None], (n,) + x.shape),
                         sample), NamedSharding(mesh, P("data")))
        put = lambda: jax.device_put(state0, NamedSharding(mesh, P()))
        t0 = time.perf_counter()
        step = make_train_step(net, tx, cfg, mesh, warmup=True).lower(
            put(), batch).compile()
        timed(f"DP train step on {n} card(s): compile", t0)
        runs = []
        for _ in range(2):
            new, m = step(put(), batch)      # the state is donated
            after = jax.tree.leaves(_np((new.params, new.alphas)))
            runs.append(([a - b for a, b in zip(after, before)],
                         float(m["loss"])))
        return runs, _collectives(step)

    (u1, l1), (u1b, l1b) = dp_step(1)[0]
    runs4, coll4 = dp_step(4)
    (u4, l4) = runs4[0]
    n1 = _norms(u1)
    e_rep = _norms([a - b for a, b in zip(u1b, u1)])
    e_dp = _norms([a - b for a, b in zip(u4, u1)])
    g, g_rep, g_dp = (float(np.linalg.norm(x)) for x in (n1, e_rep, e_dp))
    over = e_dp > 0.5 * n1 + 3 * e_rep + 1e-4 * g
    worst = int(np.argmax(e_dp / (n1 + 1e-30)))
    log(f"DP: loss 1 card {l1:.6f} (again {l1b:.6f}), 4 cards {l4:.6f}; "
        f"|mean grad| {g:.6e}; |1 card - again| {g_rep:.3e}, "
        f"|4 cards - 1 card| {g_dp:.3e}; worst leaf {worst}: "
        f"{e_dp[worst]:.3e} of {n1[worst]:.3e} (again {e_rep[worst]:.3e});"
        f" collectives on 4 cards: {coll4}")
    # The backward's bf16 scatter-adds accumulate with atomics in a
    # run-dependent order, so two runs on one card differ (g_rep); the
    # 4-card gradient is the mean of four such runs.  Bounds: twice that
    # floor plus 1 % of the gradient overall, and per leaf half its norm
    # plus three times its floor plus 1e-4 of the whole.  A flipped
    # sign, a 4x scale or a missing leaf is off by its whole norm.
    fails = []
    if not abs(l4 - l1) <= 2 * abs(l1b - l1) + 1e-5 * abs(l1):
        fails.append("DP: loss differs from 1 card")
    if not g_rep <= 0.05 * g:
        fails.append("DP: run-to-run floor too high to see a fault")
    if not g_dp <= 2 * g_rep + 1e-2 * g:
        fails.append("DP: mean gradient differs from 1 card")
    if over.any():
        fails.append(f"DP: {over.sum()} gradient leaves differ from 1 "
                     f"card, first {np.flatnonzero(over)[:8].tolist()}")
    if "all-reduce" not in coll4:
        fails.append("DP: no all-reduce in the 4-card step")

    fwd = jax.jit(lambda v, e: net.apply(v, e, train=False)["odometry"])
    o1 = np.asarray(fwd(variables, ex0))
    for label, make, axis in (("SP", make_spatial_forward, "space"),
                              ("TP", make_model_forward, "model")):
        mesh = Mesh(np.array(devs[:4]), (axis,))
        t0 = time.perf_counter()
        f4 = make(net, mesh, axis=axis).lower(variables, ex0).compile()
        timed(f"{label} forward on 4 cards: compile", t0)
        o4 = np.asarray(f4(variables, ex0)["odometry"])
        coll = _collectives(f4)
        d = float(np.abs(o4 - o1).max())
        log(f"{label}: max |odometry diff| vs 1 card {d:.3e} (max |odometry|"
            f" {np.abs(o1).max():.3e}); collectives: {coll}")
        # bf16 activations: a conv split over cards may round its output
        # differently by one bf16 ulp (2^-8 relative), and the vote sums
        # such differences over the map.
        if not np.allclose(o4, o1, rtol=1e-2, atol=1e-3):
            fails.append(f"{label}: odometry differs from 1 card")
        if not coll:
            fails.append(f"{label}: no collective in the 4-card program")
    check(not fails, "; ".join(fails))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = p.parse_args(argv)
    devs = phase_device(args.cards)
    if args.cards == 4:
        four_cards(devs)
    else:
        one_card()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
