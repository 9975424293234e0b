"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree children,
except those declared with :func:`static_field`, which become part of the
tree structure (hashable metadata: shapes, static sizes).  Instances get
``replace(**changes)``.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A field kept out of the pytree's children (must be hashable)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
