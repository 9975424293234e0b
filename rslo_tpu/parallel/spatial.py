"""Spatial partitioning (SP) of the dense BEV stage.

A new parallel axis beyond the reference's pure data parallelism
(reference scaling = DDP only, /root/reference/train_hdf5.py:594-814):
the BEV grid's width dimension is sharded over a mesh axis and XLA's
SPMD partitioner inserts the halo exchanges (collective-permutes) that
every 3x3 conv needs — the SPMD alternative to hand-written
halo code.  Use case: cutting single-scan *latency* below one-chip
inference time; data parallelism only scales throughput.

Mechanism: :func:`make_spatial_forward` jits the plain forward under a
trace-time context that makes :func:`bev_constraint` (called by
``OdomNet`` on the (pairs, H, W, C) BEV pair tensor) attach a
``with_sharding_constraint``.  GSPMD propagates the sharding through
the whole BEV encoder/decoder; the ego-motion vote's spatial
reductions come out as cross-shard collectives, so the returned pose
is bit-identical in structure (replicated) to the unsharded run.
Validated against the single-device forward in tests/test_spatial.py.
"""
from __future__ import annotations

import contextlib

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_BEV_SHARDING = None


def bev_constraint(x):
    """Attach the active spatial sharding to a (..., H, W, C) BEV map.

    No-op unless tracing happens inside :func:`make_spatial_forward`
    (or another ``_active`` context), so the regular data-parallel
    paths are untouched.
    """
    if _BEV_SHARDING is None:
        return x
    return jax.lax.with_sharding_constraint(x, _BEV_SHARDING)


@contextlib.contextmanager
def _active(sharding):
    global _BEV_SHARDING
    prev = _BEV_SHARDING
    _BEV_SHARDING = sharding
    try:
        yield
    finally:
        _BEV_SHARDING = prev


def make_spatial_forward(net, mesh: Mesh, axis: str = "space",
                         train: bool = False):
    """jitted (variables, example) -> preds with the BEV stage sharded
    over ``mesh[axis]`` along the grid width.  ``example`` is a single
    sample (no batch axis), replicated on entry; weights replicated.
    """
    sharding = NamedSharding(mesh, P(None, None, axis, None))

    def fwd(variables, example):
        with _active(sharding):   # active during trace => constraints land
            return net.apply(variables, example, train=train)

    return jax.jit(fwd)
