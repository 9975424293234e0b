"""Dense masked 3D-conv middle extractor.

Functionally equivalent to :class:`SparseMiddleCov` (same channel plan as
the reference SpMiddleFHDWithCov2_3, /root/reference/rslo/models/middle.py)
but computed on the dense voxel grid with XLA Conv3D instead
of gather/scatter sparse kernels:

  * active-voxel features are scattered into an NDHWC grid once;
  * a "submanifold" conv is a dense conv followed by multiplication with
    the level's occupancy mask (inactive neighbors contribute zero both
    ways — bit-identical semantics to the rulebook engine);
  * a strided conv's occupancy is the strided occupancy-dilation of the
    input mask; an inverse conv masks a transposed conv by the finer
    level's occupancy;
  * per-voxel covariance params come from one final gather at the input
    voxel coordinates.

Regular memory access, dense convs, no rulebooks: this trades FLOPs on
empty space (0.1% density) for eliminating the row gathers.  bf16
activations, fp32 accumulation.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from .. import nn

from ..config.schema import MiddleCfg
from ..utils.mesh_axis import axis_present

HI = jax.lax.Precision.HIGHEST


def conv3d(x, w, stride, padding):
    """x: (1, D, H, W, C); w: (kd, kh, kw, Cin, Cout).

    No explicit preferred_element_type: bf16 convs accumulate in fp32
    internally, and mixing an f32 output with bf16 operands breaks the
    autodiff transpose (dtype-mismatched backward convs)."""
    return jax.lax.conv_general_dilated(
        x, w.astype(x.dtype), window_strides=stride, padding=padding,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


class DenseConv(nn.Module):
    features: int
    kernel: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[Tuple[int, int], ...] = ((1, 1), (1, 1), (1, 1))

    @nn.compact
    def __call__(self, x, occ_out):
        """x: (1, D, H, W, C) bf16; occ_out: (1, D', H', W', 1) mask of
        the OUTPUT level (post-stride)."""
        cin = x.shape[-1]
        w = self.param("kernel", nn.initializers.he_normal(),
                       self.kernel + (cin, self.features), jnp.float32)
        b = self.param("bias", nn.initializers.zeros, (self.features,),
                       jnp.float32)
        y = conv3d(x, w, self.stride, self.padding) + b
        y = y * occ_out  # bias only lives at active sites
        return y.astype(x.dtype)


class DenseConvTranspose(nn.Module):
    """Inverse conv: transposed conv masked by the finer occupancy."""
    features: int
    kernel: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (2, 2, 2)
    padding: Tuple[Tuple[int, int], ...] = ((1, 1), (1, 1), (1, 1))
    out_shape: Tuple[int, int, int] = ()

    @nn.compact
    def __call__(self, x, occ_fine):
        cin = x.shape[-1]
        w = self.param("kernel", nn.initializers.he_normal(),
                       self.kernel + (cin, self.features), jnp.float32)
        b = self.param("bias", nn.initializers.zeros, (self.features,),
                       jnp.float32)
        # transposed conv: lhs-dilated conv with flipped spatial kernel
        pad = tuple((self.kernel[d] - 1 - self.padding[d][0],
                     self.kernel[d] - 1 - self.padding[d][1] +
                     (self.out_shape[d] - ((x.shape[1 + d] - 1) *
                                           self.stride[d] - 2 *
                                           self.padding[d][0] +
                                           self.kernel[d])))
                    for d in range(3))
        y = jax.lax.conv_general_dilated(
            x, jnp.flip(w, (0, 1, 2)).astype(x.dtype),
            window_strides=(1, 1, 1), padding=pad,
            lhs_dilation=self.stride,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + b
        y = y * occ_fine
        return y.astype(x.dtype)


class DenseMaskedBN(nn.Module):
    """BN over active grid cells with running stats (sync optional)."""
    sync: bool = False
    momentum: float = 0.99
    eps: float = 1e-3

    @nn.compact
    def __call__(self, x, occ, train: bool):
        C = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (C,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (C,), jnp.float32)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((C,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((C,), jnp.float32))
        if train:
            xf = x.astype(jnp.float32)
            n = jnp.sum(occ) * 1.0 + 1e-6
            s1 = jnp.sum(xf * occ, axis=(0, 1, 2, 3))
            s2 = jnp.sum(xf * xf * occ, axis=(0, 1, 2, 3))
            if self.sync and axis_present("data"):
                n = jax.lax.psum(n, "data")
                s1 = jax.lax.psum(s1, "data")
                s2 = jax.lax.psum(s2, "data")
            mean = s1 / n
            var = jnp.maximum(s2 / n - mean * mean, 0.0)
            if not self.is_initializing():
                ra_mean.value = (self.momentum * ra_mean.value +
                                 (1 - self.momentum) * mean)
                ra_var.value = (self.momentum * ra_var.value +
                                (1 - self.momentum) * var)
        else:
            mean, var = ra_mean.value, ra_var.value
        y = (x.astype(jnp.float32) - mean) * jax.lax.rsqrt(var + self.eps)
        y = (y * scale + bias) * occ
        return y.astype(x.dtype)


def _occupancy_down(occ, kernel, stride, padding):
    """Output-site occupancy of a strided conv: any active input in the
    window."""
    y = jax.lax.reduce_window(
        occ, 0.0, jax.lax.max, (1,) + tuple(kernel) + (1,),
        (1,) + tuple(stride) + (1,),
        ((0, 0),) + tuple(padding) + ((0, 0),))
    return y


class DenseMiddleCov(nn.Module):
    """Dense middle net + covariance decoder.  Same interface contract as
    SparseMiddleCov but takes (features, coords, vmask, grid_shape)."""
    cfg: MiddleCfg
    sparse_shape: Tuple[int, int, int]  # (nz, ny, nx)

    def _norm(self, x, occ, train):
        if self.cfg.bn_type == "none":
            return x
        return DenseMaskedBN(sync=self.cfg.bn_type == "sync_bn")(
            x, occ, train)

    @nn.compact
    def __call__(self, voxel_features: jax.Array, coords: jax.Array,
                 vmask: jax.Array, train: bool):
        """voxel_features: (V, F); coords: (V, 3) zyx; vmask: (V,).
        Returns (bev (H, W, C*D), cov_params (V, 7))."""
        c0, c1, c2, c3 = self.cfg.channels
        nz, ny, nx = self.sparse_shape
        V = voxel_features.shape[0]

        # scatter features + occupancy into the dense grid
        cz = jnp.where(vmask, coords[:, 0], nz)  # park invalid out
        grid = jnp.zeros((nz + 1, ny, nx, voxel_features.shape[-1]),
                         jnp.bfloat16)
        grid = grid.at[cz, coords[:, 1], coords[:, 2]].set(
            voxel_features.astype(jnp.bfloat16))
        occ0 = jnp.zeros((nz + 1, ny, nx, 1), jnp.float32)
        occ0 = occ0.at[cz, coords[:, 1], coords[:, 2]].set(1.0)
        x = grid[None, :nz]
        occ0 = occ0[None, :nz]

        relu = nn.relu
        p1 = ((1, 1), (1, 1), (1, 1))

        def subm(x, occ, feats, n_layers):
            for _ in range(n_layers):
                x = DenseConv(feats)(x, occ)
                x = relu(self._norm(x, occ, train))
            return x

        # encoder
        x = subm(x, occ0, c0, 2)
        occ1 = _occupancy_down(occ0, (3, 3, 3), (2, 2, 2), p1)
        x = DenseConv(c1, stride=(2, 2, 2))(x, occ1)
        x = relu(self._norm(x, occ1, train))
        x = subm(x, occ1, c1, 2)
        occ2 = _occupancy_down(occ1, (3, 3, 3), (2, 2, 2), p1)
        x = DenseConv(c2, stride=(2, 2, 2))(x, occ2)
        x = relu(self._norm(x, occ2, train))
        x_mid, occ_mid = x, occ2

        # tail
        x = subm(x, occ2, c2, 3)
        p_z0 = ((0, 0), (1, 1), (1, 1))
        occ3 = _occupancy_down(occ2, (3, 3, 3), (2, 2, 2), p_z0)
        x = DenseConv(c3, stride=(2, 2, 2), padding=p_z0)(x, occ3)
        x = relu(self._norm(x, occ3, train))
        x = subm(x, occ3, c3, 3)
        pz = ((0, 0), (0, 0), (0, 0))
        occ4 = _occupancy_down(occ3, (3, 1, 1), (2, 1, 1), pz)
        x = DenseConv(c3, kernel=(3, 1, 1), stride=(2, 1, 1),
                      padding=pz)(x, occ4)
        x = relu(self._norm(x, occ4, train))

        # dense BEV: (1, D, H, W, C) -> (H, W, D*C)
        _, D, H, W, C = x.shape
        bev = jnp.transpose(x[0], (1, 2, 0, 3)).reshape(H, W, D * C)
        bev = bev.astype(jnp.float32)

        # covariance decoder (plain masked BN, mirroring the reference)
        bn = lambda: DenseMaskedBN(sync=False)
        l2_shape = tuple(occ_mid.shape[1:4])
        l1_shape = tuple(occ1.shape[1:4])
        l0_shape = tuple(occ0.shape[1:4])
        y = DenseConvTranspose(c1, out_shape=l1_shape)(x_mid, occ1)
        y = relu(bn()(y, occ1, train))
        y = DenseConv(c1)(y, occ1)
        y = relu(bn()(y, occ1, train))
        y = DenseConvTranspose(c0, out_shape=l0_shape)(y, occ0)
        y = relu(bn()(y, occ0, train))
        y = DenseConv(c0)(y, occ0)
        y = relu(bn()(y, occ0, train))
        y = DenseConv(c0)(y, occ0)
        y = relu(bn()(y, occ0, train))
        y = DenseConv(self.cfg.cov_channels)(y, occ0)

        # gather per-voxel covariance params at the input coords
        cov = y[0][jnp.minimum(coords[:, 0], nz - 1), coords[:, 1],
                   coords[:, 2]].astype(jnp.float32)
        cov = jnp.concatenate(
            [nn.elu(cov[:, :3]) + 1 + 1e-6, cov[:, 3:]], axis=-1)
        cov = jnp.where(vmask[:, None], cov, 0.0)
        return bev, cov
