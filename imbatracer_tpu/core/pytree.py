"""Frozen dataclasses registered as JAX pytrees.

`@dataclass` makes a frozen dataclass whose fields are pytree children,
except those declared with `static_field()`, which become part of the
treedef (hashable, compared at trace time).  Instances get a `.replace`
method that returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A field that is static metadata, not a pytree child."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = dataclasses.replace
    return cls
