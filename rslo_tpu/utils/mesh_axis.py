"""Mesh-axis introspection for cross-replica statistics.

The sync-BN variants psum raw moments over the "data" mesh axis when
tracing inside shard_map and silently use local statistics outside a
mesh (single-device eval, unit tests).  A bare try/except NameError
around lax.psum would also swallow a *misspelled* axis name forever —
so presence is checked explicitly against the tracer's axis
environment.
"""
from __future__ import annotations

import jax


def axis_present(name: str) -> bool:
    """True iff the named mesh axis is bound in the current trace
    (i.e. we are inside shard_map/pmap over that axis)."""
    try:
        from jax._src.core import get_axis_env
        return bool(get_axis_env().axis_exists(name))
    except Exception:
        # introspection API moved: fall back to probing
        try:
            jax.lax.axis_index(name)
            return True
        except NameError:
            return False


def pmean_if_present(x, name: str):
    """lax.pmean over ``name`` when bound, identity otherwise."""
    if axis_present(name):
        return jax.lax.pmean(x, name)
    return x
