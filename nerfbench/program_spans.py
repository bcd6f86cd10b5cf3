"""The port's own spans laid on the device trace of a traced run.

While a profiler records, the port (``torch_nerf_tpu_torch.tracing``)
stores a span for each of its phases, stamped in ns on the Unix clock, so
its store holds the spans of both traced passes. A Chrome trace's times
are that clock less the header's ``baseTimeNanoseconds``, which
``trace.summarize`` drops. The base is recovered from the pass with
spans: in a train cell each ``nb:step`` span is paired, in order, with the
port's ``train.step`` unit of that pass, the last units stored; in a
render cell, whose stretch holds only 2-4 frames, each ``nb:chunk`` span
(the benchmark's wrapper around ``renderer.render_rays``) with the first
port span inside it, the chunk's ``sample.coarse``. The base is the median
of their start differences: one value a process, which serves both
passes. Where those differences spread (the distance between their
quartiles) by more than :data:`MAX_SPREAD_S`, or nothing pairs, the split
is None and standard error says why.

The device-only pass's idle gaps (``Trace.busy_intervals``) are named by
the deepest port span open when each began, following parent links across
threads (:class:`Spans`: the benchmark reads only the port's stored
records, and decides the attribution itself), among the spans of that
pass, chosen by time: ``field`` where that span is a ``field.*`` span, ``unit`` where it
lies inside the cell's unit, else ``outside``. The three add up to the
pass's idle (``device_idle_pct.*``).
"""

from __future__ import annotations

import bisect
import collections
import statistics
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from nerfbench.metrics._common import traced

MAX_SPREAD_S = 50e-6
# the port's unit of a job, whose idle outside the field is the unit's
UNITS = {"train": "train.step", "render": "render.frame"}
# the benchmark's span paired with a port span (name, its parent's name) to recover the base
PAIRS = {"train": ("step", "train.step", None), "render": ("chunk", "sample.coarse", "render.chunk")}


def _say(msg: str) -> None:
    print(f"program_spans: {msg}", file=sys.stderr)


def port_records() -> Optional[List[dict]]:
    """The port's stored spans (name, id, parent, start and end), or None
    where the port has no tracing."""
    try:
        from torch_nerf_tpu_torch import tracing
    except ImportError:
        return None
    return [dict(name=r.name, id=r.id, parent=r.parent, start=r.start, end=r.end) for r in tracing.records()]


def offset(span_trace, records: List[dict], job: str) -> Optional[Tuple[int, float, float, int]]:
    """``(base ns, spread s, range s, pairs)``: the port's clock less the
    trace's, from the pass with spans; None (said on standard error) where
    it cannot be told."""
    nb_name, port_name, parent_name = PAIRS[job]
    nb = sorted(a for name, _, a, _ in span_trace.spans if name == nb_name)
    names = {r["id"]: r["name"] for r in records}
    units = sorted(r["start"] for r in records
                   if r["name"] == port_name and (parent_name is None or names.get(r["parent"]) == parent_name))
    if not nb or len(units) < len(nb):
        _say(f"no pairing: {len(nb)} nb:{nb_name} spans, {len(units)} port {port_name} spans")
        return None
    diffs = [u - round(a * 1e9) for a, u in zip(nb, units[-len(nb):])]
    least = min(diffs)  # the differences relative to their least: exact in floats
    rel = [d - least for d in diffs]
    base = least + round(statistics.median(rel))
    if len(rel) >= 2:
        q = statistics.quantiles(rel, n=4)
        spread = (q[2] - q[0]) * 1e-9
    else:
        spread = 0.0
    rng = max(rel) * 1e-9
    if spread > MAX_SPREAD_S:
        _say(f"the base's differences spread {spread!r} s over {len(diffs)} pairs (range {rng!r} s), "
             f"more than {MAX_SPREAD_S!r} s")
        return None
    return base, spread, rng, len(diffs)


class Spans:
    """Spans (dicts with ``id``, ``parent``, ``name``, ``start``, ``end``
    in one clock) indexed by time: :meth:`deepest` is the deepest open at a
    time, its depth by parent links across threads, the later start between
    equals."""

    def __init__(self, spans: Iterable[dict]):
        self.spans = sorted(spans, key=lambda s: s["start"])
        self.by_id = {s["id"]: s for s in self.spans}
        self.depth: Dict[int, int] = {}
        for s in self.spans:
            chain = []
            while s is not None and s["id"] not in self.depth:
                chain.append(s)
                s = self.by_id.get(s["parent"])
            d = self.depth[s["id"]] if s is not None else -1
            for c in reversed(chain):
                d += 1
                self.depth[c["id"]] = d
        self.starts = [s["start"] for s in self.spans]
        # the longest span up to each index bounds how far back an open one can start
        self.reach, longest = [], 0.0
        for s in self.spans:
            longest = max(longest, s["end"] - s["start"])
            self.reach.append(longest)

    def deepest(self, t) -> Optional[dict]:
        """The deepest span with ``start <= t < end``, or None."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return None
        best = None
        for s in self.spans[bisect.bisect_left(self.starts, t - self.reach[i - 1]):i]:
            if s["end"] > t and (best is None or self.depth[s["id"]] >= self.depth[best["id"]]):
                best = s
        return best

    def ancestors(self, s) -> Iterable[dict]:
        """``s`` and its parents, innermost first."""
        while s is not None:
            yield s
            s = self.by_id.get(s["parent"])


def gaps(trace) -> List[Tuple[float, float]]:
    """``(start, length)`` of each idle gap of ``trace``'s window."""
    out, t = [], trace.window[0]
    for a, b in trace.busy_intervals() + [(trace.window[1], trace.window[1])]:
        if a > t:
            out.append((t, a - t))
        t = max(t, b)
    return out


def split_idle(trace, span_trace, records: List[dict], job: str) -> Optional[Dict[str, float]]:
    """Idle seconds of the device-only pass ``trace``: ``field``, ``unit``
    and ``outside``, ``by_span`` (by the deepest span's name, ``-`` where
    none was open), with the base's ``spread`` and ``pairs``; None where
    the clocks cannot be aligned."""
    got = offset(span_trace, records, job)
    if got is None:
        return None
    base, spread, rng, pairs = got
    lo, hi = trace.window
    on_trace = [dict(r, start=(r["start"] - base) * 1e-9, end=(r["end"] - base) * 1e-9) for r in records]
    timeline = Spans(r for r in on_trace if r["end"] > lo and r["start"] < hi)
    unit_name = UNITS[job]
    out = {"field": 0.0, "unit": 0.0, "outside": 0.0}
    by_span: Dict[str, float] = collections.defaultdict(float)
    for start, length in gaps(trace):
        s = timeline.deepest(start)
        by_span[s["name"] if s is not None else "-"] += length
        if s is not None and s["name"].startswith("field."):
            out["field"] += length
        elif s is not None and any(a["name"] == unit_name for a in timeline.ancestors(s)):
            out["unit"] += length
        else:
            out["outside"] += length
    out.update(spread=spread, range=rng, pairs=pairs, spans=len(timeline.spans), by_span=dict(by_span))
    return out


def idle_pct(run, job: str, part: str) -> Optional[float]:
    """``part`` (``field`` or ``unit``) of the device-only pass's idle, as
    % of its window; the split is made once a run and said on standard
    error with its check against the pass's whole idle."""
    if not traced(run, job) or run.span_trace is None:
        return None
    if "program_idle" not in run.kept:
        records = port_records()
        if records is None:
            _say("the port has no tracing module; nothing to read")
            run.kept["program_idle"] = None
        else:
            run.kept["program_idle"] = split_idle(run.trace, run.span_trace, records, job)
            report(run, run.kept["program_idle"], job)
    parts = run.kept["program_idle"]
    return None if parts is None else 100.0 * parts[part] / run.trace.window_s


def report(run, parts: Optional[Dict[str, float]], job: str) -> None:
    if parts is None:
        return
    w = run.trace.window_s
    idle = 100.0 * (1.0 - run.trace.busy_s() / w)
    pct = {k: 100.0 * parts[k] / w for k in ("field", "unit", "outside")}
    _say(f"base from {parts['pairs']} paired spans, spread {parts['spread']!r} s (range {parts['range']!r} s); "
         f"{parts['spans']} port spans in the device-only pass; idle % of its window: field {pct['field']!r}, "
         f"{UNITS[job]} {pct['unit']!r}, outside the port's units (the remainder) {pct['outside']!r}; "
         f"sum {sum(pct.values())!r} against device_idle_pct {idle!r}")
    ranked = sorted(parts["by_span"].items(), key=lambda kv: -kv[1])
    _say("idle % of the window by the deepest port span: "
         + ", ".join(f"{name} {100.0 * s / w:.4f}" for name, s in ranked))
