"""Frozen dataclasses registered as JAX pytrees.

``@pytree.dataclass`` makes a frozen dataclass whose fields are pytree
leaves, except those declared with ``static_field()``, which become static
aux data (changing them recompiles). Instances get ``.replace(**changes)``.
Built on `jax.tree_util.register_dataclass`, so the main path needs nothing
beyond jax and numpy.
"""

from __future__ import annotations

import dataclasses

import jax

_STATIC = "ptre_static"


def static_field(**kwargs):
    """A dataclass field kept as static pytree metadata, not a leaf."""
    return dataclasses.field(metadata={_STATIC: True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration (data vs static fields)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if not f.metadata.get(_STATIC)]
    meta = [f.name for f in fields if f.metadata.get(_STATIC)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
