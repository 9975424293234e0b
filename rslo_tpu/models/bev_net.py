"""BEV odometry encoder/decoder ("Geometric Unit Transformation
Estimation" stage).

Re-designs the reference's mask-conv ResNet enc/dec + dense tq-map +
confidence voting head (/root/reference/rslo/models/odom_pred_base.py and
odom_pred.py) as channels-last NHWC modules:

  * every feature tensor travels as an (x, mask) pair; convs propagate the
    validity mask by max-pooling (MaskConv semantics,
    rslo/layers/MaskConv.py:20-73), residual adds average the masks
    (custom_resnet_spc.py:41-47);
  * BatchNorm is optionally cross-replica (axis_name="data") — the
    analog of apex SyncBN selected by ``bn_type: sync_bn``;
  * the decoder emits a 7-channel local tq map plus translation/rotation
    confidence fields (masked spatial softmax or elu+1), deep-supervision
    pyramid motion maps, and the ego-motion vote (confidence-weighted
    average of the decoded global pose map, or weighted-Kabsch on the
    dense scene-flow field).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from .. import nn

from ..config.schema import OdomCfg
from ..utils.mesh_axis import axis_present
from ..geometry import (decode_tq_map, grid_cell_coords, qnormalize,
                        weighted_kabsch)


def identity_pose_bias(key, shape, dtype=jnp.float32):
    """Bias init for 7-channel tq heads: identity pose [0,0,0, 1,0,0,0].

    A zero bias makes the quaternion channels exactly 0 at init, whose
    normalization has an unbounded derivative — with fully-masked inputs
    that surfaces as NaN grads.  Identity is also the right prior for
    ego-motion heads."""
    b = jnp.zeros(shape, dtype)
    return b.at[3].set(1.0)


def max_pool_mask(mask: jax.Array, kernel: int, stride: int) -> jax.Array:
    """Max-pool a (B, H, W, 1) mask with SAME padding (mask propagation)."""
    return nn.max_pool(mask, (kernel, kernel), (stride, stride),
                       padding="SAME")


class MaskConv(nn.Module):
    """Conv on features + max-pool on the validity mask.

    ``normalized=True`` gives the reference's alternative ``SparseConv``
    conv_type (rslo/layers/SparseConv.py:222-302): conv(x*m) scaled by
    the reciprocal valid-tap count (a frozen all-ones sum-conv over the
    mask), bias added after normalization — partial-conv semantics that
    keep activations magnitude-invariant near mask boundaries."""
    features: int
    kernel: int = 3
    stride: int = 1
    use_bias: bool = False
    groups: int = 1
    dtype: object = None
    normalized: bool = False

    @nn.compact
    def __call__(self, x, mask):
        if self.normalized:
            x = x * mask.astype(x.dtype)
        y = nn.Conv(self.features, (self.kernel, self.kernel),
                    strides=(self.stride, self.stride), padding="SAME",
                    use_bias=self.use_bias and not self.normalized,
                    dtype=self.dtype, param_dtype=jnp.float32,
                    feature_group_count=self.groups)(x)
        if self.normalized:
            ones = jnp.ones((self.kernel, self.kernel, 1, 1), y.dtype)
            msum = jax.lax.stop_gradient(jax.lax.conv_general_dilated(
                mask.astype(y.dtype), ones,
                (self.stride, self.stride), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")))
            y = y / jnp.maximum(msum, 1.0)
            if self.use_bias:
                b = self.param("norm_bias", nn.initializers.zeros,
                               (self.features,), jnp.float32)
                y = y + b.astype(y.dtype)
            m = jax.lax.stop_gradient((msum > 0).astype(mask.dtype))
            return y, m
        m = jax.lax.stop_gradient(
            max_pool_mask(mask, self.kernel, self.stride))
        return y, m


class Norm(nn.Module):
    """BatchNorm with optional cross-replica stats (SyncBN analog).

    bn_type: "none" | "bn" | "sync_bn".  The sync path psums the raw
    moments over the mesh "data" axis explicitly — flax's
    BatchNorm(axis_name=...) produces NaN gradients under shard_map on
    this stack, so the statistics are hand-rolled.
    """
    bn_type: str = "sync_bn"
    momentum: float = 0.99
    eps: float = 1e-3
    # Per-channel train-time noise injection after normalization
    # ((x + shift) * scale, shift ~ N(0, shift_std), scale ~ N(1,
    # scale_std)) — the SPC wrappers' regularization option
    # (rslo/layers/SparseConv.py:22-219, noise_scale_std /
    # noise_shift_std).  Like the reference, no deployed config sets it
    # (the builders never pass nonzero); callers that want it supply an
    # rng stream named "bn_noise".
    noise_scale_std: float = 0.0
    noise_shift_std: float = 0.0

    @nn.compact
    def __call__(self, x, train: bool):
        if self.bn_type == "none":
            return x
        if self.bn_type == "semiglobal_sync_bn":
            from .semiglobal_bn import SemiGlobalSyncBN
            return SemiGlobalSyncBN()(x, train)
        C = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (C,),
                           jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (C,),
                          jnp.float32)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((C,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((C,), jnp.float32))
        if train:
            xf = x.astype(jnp.float32)
            axes = tuple(range(x.ndim - 1))
            mu = jnp.mean(xf, axis=axes)
            m2 = jnp.mean(xf * xf, axis=axes)
            if self.bn_type == "sync_bn" and axis_present("data"):
                mu = jax.lax.pmean(mu, "data")
                m2 = jax.lax.pmean(m2, "data")
            var = jnp.maximum(m2 - mu * mu, 0.0)
            if not self.is_initializing():
                ra_mean.value = (self.momentum * ra_mean.value +
                                 (1 - self.momentum) * mu)
                ra_var.value = (self.momentum * ra_var.value +
                                (1 - self.momentum) * var)
        else:
            mu, var = ra_mean.value, ra_var.value
        y = (x.astype(jnp.float32) - mu) * jax.lax.rsqrt(var + self.eps)
        y = y * scale + bias
        # Deliberate deviation from the reference SPC wrappers
        # (rslo/layers/SparseConv.py:46-53): there, noise is applied
        # unconditionally (eval included) and SPC_MaskSyncBN2d re-masks
        # after the noise.  Here it is train-only and NOT re-masked
        # (nshift makes padded zeros nonzero) — acceptable because no
        # deployed config enables it; see PARITY.md §2.5 [ADVICE r3].
        if train and (self.noise_scale_std or self.noise_shift_std):
            ks, ksh = jax.random.split(self.make_rng("bn_noise"))
            nscale = 1.0 + self.noise_scale_std * jax.random.normal(
                ks, (C,), jnp.float32)
            nshift = self.noise_shift_std * jax.random.normal(
                ksh, (C,), jnp.float32)
            y = (y + nshift) * nscale
        return y.astype(x.dtype)


class BasicBlock(nn.Module):
    """Mask-aware ResNet BasicBlock; residual add averages the masks.
    Optional SE/spatial attention on the residual branch
    (custom_resnet_spc.py use_se/use_sa)."""
    features: int
    stride: int = 1
    bn_type: str = "sync_bn"
    groups: int = 1
    dtype: object = None
    use_se: bool = False
    use_sa: bool = False
    normalized: bool = False   # conv_type == "sparse_conv"

    @nn.compact
    def __call__(self, x, mask, train: bool):
        y, m = MaskConv(self.features, 3, self.stride,
                        groups=self.groups, dtype=self.dtype,
                        normalized=self.normalized)(x, mask)
        y = Norm(self.bn_type)(y, train)
        y = nn.relu(y)
        y, m = MaskConv(self.features, 3, 1, dtype=self.dtype,
                        normalized=self.normalized)(y, m)
        y = Norm(self.bn_type)(y, train)
        if self.use_se:
            from .attention import SELayer
            y = SELayer()(y)
        if self.use_sa:
            from .attention import SpatialAttention
            y = SpatialAttention()(y)
        if self.stride != 1 or x.shape[-1] != self.features:
            x, mask = MaskConv(self.features, 1, self.stride,
                               groups=self.groups, dtype=self.dtype,
                               normalized=self.normalized)(x, mask)
            x = Norm(self.bn_type)(x, train)
        out = nn.relu(x + y)
        return out, (mask + m) * 0.5


class FireBlock(nn.Module):
    """Squeeze/expand block (custom_resnet_spc.py:89-150): parallel
    1x1 and 3x3 branches from the same input, BN+relu each, channel
    concat, no residual.  ``features`` is the OUTPUT width (each branch
    emits features//2 — the reference parameterizes the per-branch
    width instead); the propagated mask is the 3x3 branch's (the union
    of spatial support)."""
    features: int
    stride: int = 1
    bn_type: str = "sync_bn"
    groups: int = 1
    dtype: object = None
    normalized: bool = False

    @nn.compact
    def __call__(self, x, mask, train: bool):
        half = self.features // 2
        a, _ = MaskConv(half, 1, self.stride, groups=self.groups,
                        dtype=self.dtype, normalized=self.normalized)(
                            x, mask)
        a = nn.relu(Norm(self.bn_type)(a, train))
        b, m = MaskConv(self.features - half, 3, self.stride,
                        groups=self.groups, dtype=self.dtype,
                        normalized=self.normalized)(x, mask)
        b = nn.relu(Norm(self.bn_type)(b, train))
        return jnp.concatenate([a, b], axis=-1), m


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 residual bottleneck
    (custom_resnet_spc.py:300-352).  ``features`` is the OUTPUT width
    (inner width features//4, the reference's planes*4 = our
    features)."""
    features: int
    stride: int = 1
    bn_type: str = "sync_bn"
    groups: int = 1
    dtype: object = None
    normalized: bool = False

    @nn.compact
    def __call__(self, x, mask, train: bool):
        inner = max(self.features // 4, 1)
        y, m = MaskConv(inner, 1, 1, dtype=self.dtype,
                        normalized=self.normalized)(x, mask)
        y = nn.relu(Norm(self.bn_type)(y, train))
        y, m = MaskConv(inner, 3, self.stride, groups=self.groups,
                        dtype=self.dtype, normalized=self.normalized)(
                            y, m)
        y = nn.relu(Norm(self.bn_type)(y, train))
        y, m = MaskConv(self.features, 1, 1, dtype=self.dtype,
                        normalized=self.normalized)(y, m)
        y = Norm(self.bn_type)(y, train)
        if self.stride != 1 or x.shape[-1] != self.features:
            x, mask = MaskConv(self.features, 1, self.stride,
                               dtype=self.dtype,
                               normalized=self.normalized)(x, mask)
            x = Norm(self.bn_type)(x, train)
        return nn.relu(x + y), (mask + m) * 0.5


BLOCK_TYPES = {"basic": BasicBlock, "fire": FireBlock,
               "bottleneck": BottleneckBlock}


class ConvBNRelu(nn.Module):
    features: int
    kernel: int = 3
    bn_type: str = "sync_bn"
    dtype: object = None

    @nn.compact
    def __call__(self, x, train: bool):
        x = nn.Conv(self.features, (self.kernel, self.kernel),
                    padding="SAME", dtype=self.dtype,
                    param_dtype=jnp.float32)(x)
        x = Norm(self.bn_type)(x, train)
        return nn.relu(x)


class ConfidenceHead(nn.Module):
    """conv stack -> per-cell confidence (masked softmax or elu+1),
    mirroring the reference ConfidenceModule
    (rslo/layers/confidence.py:5-38).

    ``tempered`` additionally returns a stop-gradient confidence at
    that temperature from the SAME logits (the reference evaluates its
    tempered pyramid-mask confidences on detached features — since the
    temperature only enters the final softmax, one conv-stem pass
    serves both)."""
    bn_type: str = "sync_bn"
    conf_type: str = "softmax"
    dtype: object = None

    @nn.compact
    def __call__(self, x, extra_mask, train: bool,
                 temperature: float = 1.0, tempered: float | None = None):
        h = ConvBNRelu(64, 3, self.bn_type, dtype=self.dtype)(x, train)
        h = ConvBNRelu(32, 3, self.bn_type, dtype=self.dtype)(h, train)
        logit = nn.Conv(1, (1, 1))(h).astype(jnp.float32)

        def finish(lg, T):
            if self.conf_type == "linear":
                return (nn.elu(lg) + 1 + 1e-12) * \
                    (extra_mask.astype(jnp.float32) + 1e-12)
            B, H, W, _ = lg.shape
            masked = jnp.where(extra_mask > 0, lg, -1000.0)
            flat = masked.reshape(B, H * W) / T
            return jax.nn.softmax(flat, axis=-1).reshape(B, H, W, 1)

        conf = finish(logit, temperature)
        if tempered is None:
            return conf
        temp = finish(jax.lax.stop_gradient(logit), tempered)
        return conf, jax.lax.stop_gradient(temp)


def cycle_pairs(xs: Sequence[jax.Array]):
    """All ordered frame pairs (i < j): returns (first, second) stacked on
    a new leading pair axis folded into batch.  xs: list of (B, ...)"""
    first, second = [], []
    L = len(xs)
    for i in range(L):
        for j in range(i + 1, L):
            first.append(xs[i])
            second.append(xs[j])
    # interleave pair-major like the reference (stack dim 1 then flatten)
    f = jnp.stack(first, axis=1)
    s = jnp.stack(second, axis=1)
    B = f.shape[0]
    return (f.reshape((-1,) + f.shape[2:]), s.reshape((-1,) + s.shape[2:]))


class BEVOdomNet(nn.Module):
    """Encoder/decoder over a pair-concatenated BEV feature map."""
    cfg: OdomCfg
    point_cloud_range: tuple

    @nn.compact
    def __call__(self, x_pair, train: bool):
        """x_pair: (P, H, W, 2*C) concatenated frame-pair features."""
        cfg = self.cfg
        assert cfg.conv_type in ("mask_conv", "sparse_conv"), (
            f"unknown conv_type {cfg.conv_type!r}; expected 'mask_conv' "
            f"or 'sparse_conv'")
        assert cfg.block_type in BLOCK_TYPES, (
            f"unknown block_type {cfg.block_type!r}; expected one of "
            f"{sorted(BLOCK_TYPES)}")
        total_stride = 1
        for s in cfg.layer_strides:
            total_stride *= s
        H_in, W_in = x_pair.shape[1:3]
        assert H_in % total_stride == 0 and W_in % total_stride == 0, (
            f"BEV dims ({H_in}, {W_in}) must divide the encoder stride "
            f"product {total_stride} (SAME-padding pooling and exact x2 "
            f"upsampling disagree otherwise); pick a point_cloud_range / "
            f"voxel_size whose grid/8 is divisible by {total_stride}")
        dt = jnp.bfloat16 if cfg.compute_dtype == "bf16" else jnp.float32
        input_mask = jax.lax.stop_gradient(
            (jnp.sum(jnp.abs(x_pair), axis=-1, keepdims=True) != 0)
            .astype(dt))

        x, m = x_pair.astype(dt), input_mask
        skips = []
        Block = BLOCK_TYPES[cfg.block_type]
        norm_conv = cfg.conv_type == "sparse_conv"
        for i, (n_blocks, stride, feats) in enumerate(zip(
                cfg.layer_nums, cfg.layer_strides, cfg.num_filters)):
            groups = cfg.first_conv_groups if i == 0 else 1
            x, m = Block(feats, stride, cfg.bn_type, groups,
                         dtype=dt, normalized=norm_conv)(x, m, train)
            for bi in range(n_blocks - 1):
                last = bi == n_blocks - 2
                extra = ({"use_se": cfg.use_se and last,
                          "use_sa": cfg.use_sa and last}
                         if Block is BasicBlock else {})
                x, m = Block(feats, 1, cfg.bn_type, dtype=dt,
                             normalized=norm_conv, **extra)(x, m, train)
            skips.append(ConvBNRelu(feats, 3, cfg.bn_type, dtype=dt)(
                x, train))

        # pyramid masks at decoder resolutions (coarse -> fine)
        py_masks = []
        p_mask = input_mask
        for i in range(len(cfg.upsample_strides) - 1):
            p_mask = max_pool_mask(p_mask, 3, cfg.upsample_strides[-(i + 1)])
            py_masks.append(p_mask)
        py_masks.reverse()

        py_preds = []
        for i, (stride, feats) in enumerate(zip(cfg.upsample_strides,
                                                cfg.num_upsample_filters)):
            x = jnp.concatenate([x, skips[-(i + 1)]], axis=-1)
            B, H, W, C = x.shape
            x = jax.image.resize(x, (B, H * stride, W * stride, C),
                                 method="nearest")
            x = ConvBNRelu(feats, 3, cfg.bn_type, dtype=dt)(x, train)
            if cfg.use_deep_supervision and i < len(cfg.upsample_strides) - 1:
                h = ConvBNRelu(feats // 2, 3, cfg.bn_type, dtype=dt)(
                    x, train)
                py = nn.Conv(7, (1, 1),
                             bias_init=identity_pose_bias)(
                                 h).astype(jnp.float32)
                pm = py_masks[i].astype(jnp.float32)
                py_preds.append((py * (pm > 0).astype(py.dtype), pm))

        if not cfg.dense_predict:
            # FC fallback head (odom_pred_base.py:284-290): pool the
            # encoder bottleneck, two dense layers -> direct [t, q].
            h = jnp.mean(skips[-1], axis=(1, 2))
            h = nn.relu(nn.Dense(1024)(h))
            h = nn.Dropout(cfg.dropout, deterministic=not train)(h)
            odom = nn.Dense(7, bias_init=identity_pose_bias)(h)
            t, q = odom[:, :3], odom[:, 3:]
            if cfg.odom_format == "r(x+t)":
                from ..geometry import rotate_vec_by_q
                t = rotate_vec_by_q(t, qnormalize(q))
            odom = jnp.concatenate([t, qnormalize(q)], axis=-1)
            dummy_map = jnp.zeros(x.shape[:3] + (7,), jnp.float32)
            return {
                "odometry": odom.astype(jnp.float32),
                "tq_map": dummy_map,
                "t_conf": jnp.ones(x.shape[:3] + (1,), jnp.float32),
                "q_conf": jnp.ones(x.shape[:3] + (1,), jnp.float32),
                "pyramid": [],
                "input_mask": input_mask,
            }

        x_tail = x
        # 7-channel local tq map head
        h = ConvBNRelu(64, 3, cfg.bn_type, dtype=dt)(x_tail, train)
        h = ConvBNRelu(32, 3, cfg.bn_type, dtype=dt)(h, train)
        tq_map = nn.Conv(7, (1, 1), bias_init=identity_pose_bias)(
            h).astype(jnp.float32)
        q = tq_map[..., 3:]
        q = q / jnp.sqrt(jnp.sum(q * q, -1, keepdims=True) + 1e-16)
        tq_map = jnp.concatenate([tq_map[..., :3], q], axis=-1)

        t_conf_head = ConfidenceHead(cfg.bn_type, cfg.conf_type, dt)
        q_conf_head = ConfidenceHead(cfg.bn_type, cfg.conf_type, dt)
        # tempered (stop-gradient) confidences compose the hierarchical
        # pyramid masks; they share the conv stem with the main confs
        t_conf, temp_t = t_conf_head(x_tail, input_mask, train,
                                     tempered=cfg.conf_temperature)
        q_conf, temp_q = q_conf_head(x_tail, input_mask, train,
                                     tempered=cfg.conf_temperature)
        temp_conf = jnp.concatenate([temp_t, temp_q], axis=-1)

        pyramid = py_preds + [(tq_map * input_mask, input_mask * temp_conf)]
        # cascade: each level's mask is modulated by the avg-pooled mask of
        # the next finer level (odom_pred.py:262-264)
        for p in range(2, len(pyramid) + 1):
            finer = pyramid[-(p - 1)][1]
            pooled = nn.avg_pool(finer, (3, 3), (2, 2), padding="SAME")
            pyramid[-p] = (pyramid[-p][0], pyramid[-p][1] * pooled)

        odom = self.aggregate(tq_map, input_mask, t_conf, q_conf)

        out = {
            "odometry": odom,                      # (P, 7) [t, q]
            "tq_map": tq_map,                      # (P, H, W, 7) local
            "t_conf": t_conf,
            "q_conf": q_conf,
            "pyramid": pyramid,                    # [(map, mask*conf), ...]
            "input_mask": input_mask,
        }
        if cfg.multi_level_odom:
            # per-level odometry votes, coarse -> fine; the finest
            # level is the main confidence-weighted aggregate
            # (reference's rotation_preds/translation_preds lists,
            # voxel_odom_net.py:597-603)
            levels = []
            for pmap, pmask in pyramid[:-1]:
                g = decode_tq_map(pmap, self.point_cloud_range)
                w = pmask[..., 0:1]
                ws = jnp.sum(w, axis=(1, 2)) + 1e-12
                t = jnp.sum(g[..., :3] * w, axis=(1, 2)) / ws
                q = jnp.sum(g[..., 3:] * w, axis=(1, 2)) / ws
                q = q / jnp.sqrt(jnp.sum(q * q, -1, keepdims=True)
                                 + 1e-16)
                levels.append(jnp.concatenate([t, q], axis=-1))
            out["odometry_levels"] = levels + [odom]
        return out

    def aggregate(self, tq_map, mask, t_conf, q_conf):
        """Ego-motion voting over the dense local-pose map."""
        pc_range = jnp.asarray(self.point_cloud_range, jnp.float32)
        if self.cfg.use_svd:
            H, W = tq_map.shape[1:3]
            coords = grid_cell_coords((H, W), self.point_cloud_range,
                                      dtype=jnp.float32)  # (H, W, 3)
            P = tq_map.shape[0]
            src = jnp.broadcast_to(coords[None], (P, H, W, 3))
            flow = tq_map[..., :3]
            w = (t_conf * mask)[..., 0].reshape(P, H * W)
            R, t = weighted_kabsch(src.reshape(P, -1, 3),
                                   (src - flow).reshape(P, -1, 3), w)
            # pack rotation matrix votes as quaternion
            from ..geometry import matrix_to_quat, hemisphere
            qv = hemisphere(matrix_to_quat(R))
            return jnp.concatenate([t, qv], axis=-1)
        g = decode_tq_map(tq_map, self.point_cloud_range)  # (P, H, W, 7)
        tw = jnp.sum(t_conf, axis=(1, 2)) + 1e-12
        qw = jnp.sum(q_conf, axis=(1, 2)) + 1e-12
        t = jnp.sum(g[..., :3] * t_conf, axis=(1, 2)) / tw
        q = jnp.sum(g[..., 3:] * q_conf, axis=(1, 2)) / qw
        q = q / jnp.sqrt(jnp.sum(q * q, -1, keepdims=True) + 1e-16)
        return jnp.concatenate([t, q], axis=-1)
