"""The check that the run loaded nothing of the JAX reference package."""

from __future__ import annotations

import sys

#: top-level module names no run may load: JAX, its libraries, and the
#: JAX package this program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "convexadam_tpu")


def forbidden_modules(modules=None) -> "list[str]":
    """The loaded modules whose top-level name (before the first dot),
    compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
