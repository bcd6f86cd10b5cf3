"""What a run may not load: JAX and the JAX package. Module names are
compared whole at their top level (the part before the first dot), since
the port's name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = ("jax", "jaxlib", "flax", "torch_nerf_tpu", "bench")


def top_levels(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def banned_loaded(names: Iterable[str] = None) -> List[str]:
    """The banned top-level names among ``names`` (``sys.modules`` by
    default)."""
    loaded = top_levels(sys.modules if names is None else names)
    return sorted(b for b in BANNED if b in loaded)
