"""Training driver: config -> mesh -> state -> step loop with periodic
eval and checkpointing.

The analog of the reference's train() loop
(/root/reference/train_hdf5.py:290-823): resumable global step, the
step-1500 warmup phase switch (recompiled variant, not traced control
flow), loss logging every display_step, eval + checkpoint every
steps_per_eval.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config.schema import PipelineCfg
from ..models.net import OdomNet
from ..utils.logging import MetricLogger
from .checkpoint import CheckpointManager
from .optim import build_optimizer
from .state import TrainState
from .step import make_eval_step, make_train_step


def data_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def shard_batch(batch: dict, mesh: Mesh):
    sharding = NamedSharding(mesh, P("data"))
    arrays = {k: v for k, v in batch.items() if k != "meta"}
    return jax.device_put(jax.tree.map(jnp.asarray, arrays), sharding)


def device_prefetch(batches, mesh: Mesh, depth: int = 2):
    """Upload batches to device from a background thread, ``depth``
    ahead of the consumer: overlapping the host-to-device transfer with
    the device's compute of the previous step takes the transfer off
    the critical path whenever compute >= transfer (and costs nothing
    otherwise)."""
    import queue as _queue
    import threading as _threading
    q: _queue.Queue = _queue.Queue(maxsize=depth)

    def run():
        try:
            for b in batches:
                b.pop("meta", None)
                q.put(shard_batch(b, mesh))
            q.put(None)
        except Exception as e:   # surface upload errors to the consumer
            q.put(e)

    _threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, Exception):
            raise item
        yield item


class Trainer:
    def __init__(self, cfg: PipelineCfg, model_dir: str,
                 mesh: Mesh | None = None, self_supervised: bool = True,
                 rank0: bool = True):
        self.cfg = cfg
        self.model_dir = Path(model_dir)
        self.mesh = mesh or data_mesh()
        self.net = OdomNet(cfg)
        self.tx = build_optimizer(cfg.optimizer, cfg.train)
        self.self_supervised = self_supervised
        self.logger = MetricLogger(model_dir, enabled=rank0)
        self.ckpt = CheckpointManager(str(self.model_dir / "ckpt"),
                                      cfg.train.checkpoint_max_keep)
        self._steps = {}

    def init_state(self, example, pretrained: str | None = None,
                   pretrained_include: str | None = None,
                   pretrained_exclude: str | None = None,
                   ckpt_step: int | None = None) -> TrainState:
        variables = self.net.init(jax.random.PRNGKey(self.cfg.train.seed),
                                  example, train=False)
        n_params = sum(x.size for x in jax.tree.leaves(variables["params"]))
        self.logger.log_text(f"model initialized: {n_params/1e6:.2f}M params")
        state = TrainState.create(
            variables, self.tx,
            {"rot": self.cfg.loss.rotation_init_alpha,
             "trans": self.cfg.loss.translation_init_alpha})
        restored = self.ckpt.restore(state, step=ckpt_step)
        if restored is not None:
            state = restored
            self.logger.log_text(
                f"restored checkpoint at step {int(state.step)}")
        elif pretrained is not None:
            # warm-start from another run's checkpoint, shape-matching
            # leaves only (the reference's pretrained_path +
            # include/exclude, train_hdf5.py:416-446)
            from ..utils.param_surgery import load_pretrained
            raw = self.ckpt.restore_raw_from(pretrained)
            params, loaded = load_pretrained(
                state.params, raw.get("params", {}), pretrained_include,
                pretrained_exclude, strict_shapes=False)
            stats, loaded_s = load_pretrained(
                state.batch_stats, raw.get("batch_stats", {}),
                pretrained_include, pretrained_exclude,
                strict_shapes=False)
            state = state.replace(params=params, batch_stats=stats)
            if "alphas" in raw:
                state = state.replace(alphas=jax.tree.map(
                    jnp.asarray, raw["alphas"]))
            self.logger.log_text(
                f"warm-started {len(loaded)} param + {len(loaded_s)} "
                f"stat leaves from {pretrained}")
        return jax.device_put(state, NamedSharding(self.mesh, P()))

    def _step_fn(self, warmup: bool):
        key = ("train", warmup)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.net, self.tx, self.cfg, self.mesh, warmup=warmup,
                self_supervised=self.self_supervised)
        return self._steps[key]

    def eval_fn(self, with_cov: bool = False):
        key = "eval_cov" if with_cov else "eval"
        if key not in self._steps:
            self._steps[key] = make_eval_step(self.net, self.cfg,
                                              self.mesh,
                                              with_cov=with_cov)
        return self._steps[key]

    def fit(self, train_iter, state: TrainState,
            eval_hook=None, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg.train
        total = max_steps or cfg.steps
        t_last = time.time()
        # step counter lives on the HOST: fetching state.step from the
        # device every iteration is a full pipeline barrier (it
        # serializes host prep/transfer with device compute).  The only
        # steady-state syncs are the display_step metrics fetch and
        # checkpoint saves.
        step_i = None
        for sharded in device_prefetch(train_iter, self.mesh):
            if step_i is None:
                step_i = int(state.step)   # one fetch to resume a leg
            if step_i >= total:
                break
            warmup = (self.self_supervised and
                      step_i <= self.cfg.loss.warmup_steps)
            state, metrics = self._step_fn(warmup)(state, sharded)
            step_i += 1
            if step_i % cfg.display_step == 0 or step_i <= 1:
                metrics = jax.tree.map(float, jax.device_get(metrics))
                dt = time.time() - t_last
                metrics["steptime_ms"] = dt / max(cfg.display_step, 1) * 1e3
                t_last = time.time()
                self.logger.log_metrics(metrics, step_i)
            if step_i % cfg.steps_per_eval == 0 and step_i > 0:
                self.ckpt.save(step_i, jax.device_get(state))
                if eval_hook is not None:
                    eval_hook(self, state, step_i)
            elif (cfg.checkpoint_interval and
                  step_i % cfg.checkpoint_interval == 0):
                # timeout-kill insurance: bounded-loss periodic save
                self.ckpt.save(step_i, jax.device_get(state))
        self.ckpt.save(int(state.step), jax.device_get(state), force=True)
        return state
