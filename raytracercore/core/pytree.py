"""Frozen dataclasses that are JAX pytrees.

Subclass :class:`PyTreeNode` and annotate fields as in a dataclass.  Every
field is a pytree leaf (a child) unless declared with
``field(static=True)``, which makes it part of the tree's static structure:
hashable metadata such as a bounce count that must stay a Python value
under ``jit``.  Instances are immutable; :meth:`PyTreeNode.replace` returns
a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    metadata = dict(kwargs.pop("metadata", None) or {}, static=static)
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: subclasses become frozen dataclasses registered with
    :func:`jax.tree_util.register_dataclass`."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields
                         if not f.metadata.get("static", False)],
            meta_fields=[f.name for f in fields
                         if f.metadata.get("static", False)])

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
