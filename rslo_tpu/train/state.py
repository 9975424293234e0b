"""Train state: params, batch stats, loss alphas, optimizer state, step."""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax
from ..utils import pytree


@pytree.dataclass
class TrainState:
    params: Any
    batch_stats: Any
    alphas: Dict[str, jax.Array]     # learned loss log-variances
    opt_state: Any
    step: jax.Array                  # () int32

    @classmethod
    def create(cls, variables, tx: optax.GradientTransformation,
               init_alphas: Dict[str, float]):
        alphas = {k: jnp.float32(v) for k, v in init_alphas.items()}
        trainable = {"params": variables["params"], "alphas": alphas}
        return cls(
            params=variables["params"],
            batch_stats=variables.get("batch_stats", {}),
            alphas=alphas,
            opt_state=tx.init(trainable),
            step=jnp.int32(0),
        )
