"""The check that nothing of JAX, nor the JAX package, is loaded.

Modules are compared by their whole top-level name, the part before the
first dot: the port ``uresnet_tpu_torch`` begins with the JAX package's
name ``uresnet_tpu`` and is not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "uresnet_tpu"})


def forbidden(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
