"""Frozen dataclasses registered as JAX pytrees.

Array fields are pytree leaves; fields made with `static_field` are part
of the tree structure (hashable, static under jit). Copy with changes via
`dataclasses.replace`.
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


def static_field(default):
    return dataclasses.field(default=default, metadata={"static": True})
