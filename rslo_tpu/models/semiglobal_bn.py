"""Semi-global synchronized BatchNorm.

Port of the reference's SemiGlobalSyncBatchNorm
(/root/reference/rslo/layers/normalization.py:113-251): during training
the layer NORMALIZES with the running statistics (not the batch
statistics), while the running stats are updated from psum-reduced batch
moments with a per-channel dynamic momentum adapted from a g^2 stability
probe:

    probe <- (1-b) probe + b val
    g2    <- clip((1-b) g2 + b ((probe-probe_old)/probe_old)^2,
                  0, mom^2)
    mom'  <- 1 - (1-mom)/(1-mom + sqrt(g2) + 1e-9)

This stabilizes batch_size-1 training (the reference's motivation for
the variant).  Explicit pmean over the mesh "data" axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .. import nn

from ..utils.mesh_axis import axis_present


class SemiGlobalSyncBN(nn.Module):
    momentum: float = 0.1
    beta: float = 0.1
    eps: float = 1e-5
    sync: bool = True

    @nn.compact
    def __call__(self, x, train: bool):
        C = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (C,),
                           jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (C,),
                          jnp.float32)
        mk = lambda v: (lambda: jnp.full((C,), v, jnp.float32))
        r_mean = self.variable("batch_stats", "mean", mk(0.0))
        r_var = self.variable("batch_stats", "var", mk(1.0))
        mean_mom = self.variable("batch_stats", "mean_dyn_mom",
                                 mk(self.momentum))
        var_mom = self.variable("batch_stats", "var_dyn_mom",
                                mk(self.momentum))
        mean_g2 = self.variable("batch_stats", "mean_g2", mk(1.0))
        var_g2 = self.variable("batch_stats", "var_g2", mk(1.0))
        mean_probe = self.variable("batch_stats", "mean_probe", mk(0.0))
        var_probe = self.variable("batch_stats", "var_probe", mk(1.0))

        if train and not self.is_initializing():
            xf = x.astype(jnp.float32)
            axes = tuple(range(x.ndim - 1))
            mu = jnp.mean(xf, axis=axes)
            m2 = jnp.mean(xf * xf, axis=axes)
            if self.sync and axis_present("data"):
                mu = jax.lax.pmean(mu, "data")
                m2 = jax.lax.pmean(m2, "data")
            var = jnp.maximum(m2 - mu * mu, 0.0)

            def update(dyn_mom, g2, probe, val):
                probe_old = probe
                probe = (1 - self.beta) * probe + self.beta * val
                diff = ((probe - probe_old) /
                        jnp.where(jnp.abs(probe_old) > 1e-12, probe_old,
                                  1e-12)) ** 2
                g2 = jnp.clip((1 - self.beta) * g2 + self.beta * diff,
                              0.0, self.momentum ** 2)
                dyn_mom = 1 - (1 - self.momentum) / (
                    1 - self.momentum + jnp.sqrt(g2) + 1e-9)
                return dyn_mom, g2, probe

            r_mean.value = (mean_mom.value * mu +
                            (1 - mean_mom.value) * r_mean.value)
            r_var.value = (var_mom.value * var +
                           (1 - var_mom.value) * r_var.value)
            mean_mom.value, mean_g2.value, mean_probe.value = update(
                mean_mom.value, mean_g2.value, mean_probe.value, mu)
            var_mom.value, var_g2.value, var_probe.value = update(
                var_mom.value, var_g2.value, var_probe.value, var)

        # normalize with the RUNNING stats (the defining trait)
        mu_use = jax.lax.stop_gradient(r_mean.value)
        var_use = jax.lax.stop_gradient(r_var.value)
        y = (x.astype(jnp.float32) - mu_use) * \
            jax.lax.rsqrt(var_use + self.eps)
        return (y * scale + bias).astype(x.dtype)
