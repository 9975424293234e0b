"""Jitted data-parallel train/eval steps over a device mesh.

Replacement for the reference's NCCL DDP loop
(/root/reference/train_hdf5.py:594-814 + rslo/utils/distributed_utils.py):
one ``shard_map``-decorated step over mesh axis "data" — gradients and
loss scalars are reduced with ``psum``/``pmean`` inside the step (the
analog of apex DDP all-reduce + the explicit loss all-reduce at
train_hdf5.py:650-669), and cross-replica BatchNorm sees the same axis
name (SyncBN analog).

The warmup phase switch (identity-R consistency + longer inner ICP before
``loss.warmup_steps``) is selected host-side: two compiled step variants,
picked by the python-level global step — no traced control flow.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..config.schema import PipelineCfg
from ..data.prepare import prepare_example, voxelizer_config
from ..losses.objective import compute_objective
from .state import TrainState


def make_train_step(net, tx: optax.GradientTransformation,
                    cfg: PipelineCfg, mesh: Mesh, *, warmup: bool,
                    self_supervised: bool = True):
    """Returns a jitted function (state, batch) -> (state, metrics).

    ``batch`` carries a leading device-batch axis sharded over the mesh
    "data" axis; each device processes one sample (reference semantics:
    per-GPU batch_size 1, middle.py:221).  Batches hold RAW padded
    points — voxelization runs on device inside this step.
    """
    pc_range = cfg.voxelizer.point_cloud_range
    vcfg = voxelizer_config(cfg)
    # voxelize_sorted_mean emits the deployed mean-VFE's features
    # directly from the sorted stream (bit-equal, ~25% faster fwd)
    from ..data.prepare import mean_vfe_ok
    mean_mode = mean_vfe_ok(cfg)

    def loss_fn(trainable, batch_stats, example):
        variables = {"params": trainable["params"],
                     "batch_stats": batch_stats}
        preds, mutated = net.apply(variables, example, train=True,
                                   mutable=["batch_stats"])
        out = compute_objective(preds, example, trainable["alphas"],
                                cfg.loss, pc_range, warmup=warmup,
                                self_supervised=self_supervised)
        return out.total, (out.aux, mutated["batch_stats"])

    def device_step(state: TrainState, batch):
        # strip the leading per-device batch axis of size 1
        batch = jax.tree.map(lambda x: x[0], batch)
        if "voxels" in batch or "voxel_features" in batch:
            example = batch
        else:
            example = prepare_example(batch["points"],
                                      batch["point_mask"], vcfg,
                                      mean_mode=mean_mode)
            example["odometry"] = batch["odometry"]
            for k in ("hier_points", "hier_mask"):
                if k in batch:
                    example[k] = batch[k]
        trainable = {"params": state.params, "alphas": state.alphas}
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (loss, (aux, new_stats)), grads = grad_fn(
            trainable, state.batch_stats, example)
        grads = jax.lax.pmean(grads, "data")
        aux = jax.lax.pmean(aux, "data")
        updates, new_opt = tx.update(grads, state.opt_state, trainable)
        new_trainable = optax.apply_updates(trainable, updates)
        # batch stats: average across replicas (sync BN running stats)
        new_stats = jax.lax.pmean(new_stats, "data")
        new_state = state.replace(
            params=new_trainable["params"],
            alphas=new_trainable["alphas"],
            batch_stats=new_stats,
            opt_state=new_opt,
            step=state.step + 1,
        )
        aux = dict(aux)
        aux["grad_norm"] = optax.global_norm(grads)
        aux.update({f"alpha_{k}": v for k, v in state.alphas.items()})
        return new_state, aux

    data_axes = P("data")
    step = jax.shard_map(
        device_step, mesh=mesh,
        in_specs=(P(), data_axes),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(step, donate_argnums=(0,))


def make_eval_step(net, cfg: PipelineCfg, mesh: Mesh,
                   with_cov: bool = False):
    """(state, example) -> (P, 7) odometry predictions per device sample,
    gathered across the mesh (the analog of evaluate.py:410-420).

    ``with_cov=True`` additionally returns the per-frame voxel point
    sets and covariance params (for covariance-weighted BA refinement):
    (odom (D,P,7), pts (D,L,V,3), covs (D,L,V,7), mask (D,L,V))."""

    vcfg = voxelizer_config(cfg)
    from ..data.prepare import mean_vfe_ok
    mean_mode = mean_vfe_ok(cfg)  # see make_train_step note

    def device_eval(params, batch_stats, batch):
        batch = jax.tree.map(lambda x: x[0], batch)
        if "voxels" in batch or "voxel_features" in batch:
            example = batch
        else:
            example = prepare_example(batch["points"],
                                      batch["point_mask"], vcfg,
                                      mean_mode=mean_mode)
        variables = {"params": params, "batch_stats": batch_stats}
        preds = net.apply(variables, example, train=False)
        odom = preds["odometry"].astype(jnp.float32)
        if with_cov:
            pts = jnp.stack([f[:, :3].astype(jnp.float32)
                             for f in preds["voxel_features"]])
            covs = jnp.stack([c.astype(jnp.float32)
                              for c in preds["voxel_covs"]])
            msk = jnp.stack(preds["voxel_masks"])
            return odom[None], pts[None], covs[None], msk[None]
        return odom[None]  # restore device axis

    out_specs = ((P("data"),) * 4) if with_cov else P("data")
    fn = jax.shard_map(
        device_eval, mesh=mesh,
        in_specs=(P(), P(), P("data")),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)
