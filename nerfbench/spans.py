"""The benchmark's spans: the port's functions wrapped at their module
attributes with ``torch.profiler.record_function``, in the traced run only.

Each file ``spans/<name>.json`` names a function by ``module`` and
``attr``; while :func:`installed` is active, every call through that
attribute records a span ``nb:<name>``. A file with ``names`` names the
span by the call's order instead (``coarse``, then ``fine``), counted
from the last call of the span named in ``reset_by``. The wrappers keep
the wrapped function's attributes (the port's launch counters), so code
that counts through the attribute still finds them.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
from pathlib import Path
from typing import Dict, Iterator

import torch

HERE = Path(__file__).resolve().parent
PREFIX = "nb:"


def table() -> Dict[str, dict]:
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "spans").glob("*.json"))}


def _wrap(fn, name: str, entry: dict, counters: Dict[str, int]):
    names = entry.get("names")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        label = name
        if names:
            i = counters.get(name, 0)
            counters[name] = i + 1
            label = names[min(i, len(names) - 1)]
        for child, parent in counters.get("_resets", {}).items():
            if parent == name:
                counters[child] = 0
        with torch.profiler.record_function(PREFIX + label):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def installed() -> Iterator[None]:
    """Wrap every function of the span table; unwrap on exit."""
    counters: Dict = {"_resets": {}}
    undo = []
    try:
        for name, entry in table().items():
            if "reset_by" in entry:
                counters["_resets"][name] = entry["reset_by"]
            module = importlib.import_module(entry["module"])
            original = getattr(module, entry["attr"])
            setattr(module, entry["attr"], _wrap(original, name, entry, counters))
            undo.append((module, entry["attr"], original))
        yield
    finally:
        for module, attr, original in reversed(undo):
            setattr(module, attr, original)


def span(name: str):
    """A span of the benchmark's own code."""
    return torch.profiler.record_function(PREFIX + name)
