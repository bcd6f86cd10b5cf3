"""The launch counts of the kernel wrappers.

A wrapper ``fn`` carries ``fn.launches``, its kernel's launches, and
``fn.shapes``, the same launches by the shape it was given (a
``collections.Counter``, so ``fn.launches == sum(fn.shapes.values())``).
:func:`count` adds one to both where the wrapper launches its kernel, and
nowhere else; :func:`reset` sets both to 0, and a wrapper's
``fn.route_launches`` (its launches by route), where it has one. Every
wrapper calls :func:`reset` where its module is imported, which lists it
in :data:`WRAPPERS` by name (``tracing`` reads the counts from there).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict

WRAPPERS: Dict[str, Callable] = {}


def reset(*fns) -> None:
    """Set each wrapper's counts to 0."""
    for fn in fns:
        WRAPPERS[fn.__name__] = fn
        fn.launches = 0
        fn.shapes = collections.Counter()
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def count(fn, shape) -> None:
    """One launch of ``fn``'s kernel, given ``shape``."""
    fn.launches += 1
    fn.shapes[shape] += 1
