"""Multi-host initialization + mesh construction.

The analog of the reference's NCCL/SLURM process-group management
(/root/reference/rslo/utils/distributed_utils.py:74-111,
train_hdf5.py:332-340): ``jax.distributed.initialize`` wires all hosts
into one runtime; the data mesh spans every device; host-local batches
feed ``jax.make_array_from_process_local_data``.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Initialize the cross-host runtime.  No-ops on single host.

    Resolves settings from explicit args, then SLURM env (the reference's
    dist_init), then JAX's own cluster detection.
    """
    if jax.distributed.is_initialized():
        return
    if coordinator is None and "SLURM_NTASKS" in os.environ:
        n = int(os.environ["SLURM_NTASKS"])
        if n > 1:
            nodes = os.environ["SLURM_NODELIST"]
            head = nodes.split(",")[0].replace("[", "").split("-")[0]
            coordinator = f"{head}:8898"
            num_processes = n
            process_id = int(os.environ["SLURM_PROCID"])
    if coordinator is not None:
        jax.distributed.initialize(coordinator, num_processes, process_id)
        return
    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        return  # this process already runs JAX on its own: single process
    try:
        jax.distributed.initialize()
    except ValueError as e:
        # no cluster configured: a single-process local run
        if "coordinator_address should be defined" not in str(e):
            raise


def global_data_mesh() -> Mesh:
    """One 'data' axis over all devices on all hosts."""
    return Mesh(np.array(jax.devices()), ("data",))


def local_device_count() -> int:
    return jax.local_device_count()


def is_rank0() -> bool:
    return jax.process_index() == 0


def host_local_batch_to_global(batch: dict, mesh: Mesh):
    """Assemble a global sharded batch from each host's local shard."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P("data"))
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sharding, x),
        batch)
