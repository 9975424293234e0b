"""rslo_tpu — a JAX (XLA + Pallas) self-supervised LiDAR odometry and
SLAM framework with the capabilities of the RSLO reference, built from
scratch; it runs on NVIDIA GPUs and on the CPU.

Subpackages:
  geometry  — quaternion/pose algebra, tq maps, Kabsch (jit-safe JAX)
  config    — typed configuration schema + presets + registries
  data      — KITTI ingestion, HDF5 store, frame-window dataset, aug
  ops       — voxelizer, sparse 3D conv, chamfer NN (XLA + Pallas)
  models    — VFE, sparse middle net w/ covariance decoder, BEV odom net
  losses    — adaptive-weighted pose losses, chamfer/ICP consistency
  train     — optax optimizer groups, pjit/shard_map train step, ckpt
  eval      — KITTI odometry metrics, trajectory tools
  pgo       — pose-graph optimization / windowed BA refinement
"""

__version__ = "0.1.0"
