"""New parallel axes beyond the reference's data parallelism.

The reference scales only by DDP over GPUs (SURVEY §2.7); this package
holds the extensions: spatial partitioning of the dense BEV
stage (``spatial``) — sharded window refinement and sharded BA live in
:mod:`rslo_tpu.pgo`.
"""
from .spatial import bev_constraint, make_spatial_forward  # noqa: F401
