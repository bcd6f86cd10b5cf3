"""Spans and counters of the port's own phases, on the profiler's clock.

A span records its name, an id, its parent's id (the innermost span open
on its thread, or the span handed over to other threads, see below), its
unit's id, the thread (its native id, as a Chrome trace names threads) and
its start and end in ns of ``time.time_ns()``: the Unix clock that
``torch.profiler`` stamps its events on, less the trace header's
``baseTimeNanoseconds``. A unit (:func:`unit`) is a span that also opens a
unit of work: a train step (``train.step``, with the state's step), a frame
(``render.frame``, with its seed: the view's index in ``run_render``) or a
chunk (``render.chunk``, with its frame and first pixel). Every span inside
a unit carries the innermost unit's id, and at a unit's end its span keeps
the unit's counter deltas, those that moved: the kernel wrappers' launches,
by wrapper and ``wrapper/route`` (:mod:`ops.launch_count`), the weight
images built (``layout_builds``) and their bytes (``layout_bytes``), and
the points the field evaluated (``points``).

Names follow the port's layers: a span named ``field.*`` belongs to the
field; any other to the layer of its unit (the train step, the frame loop).

Tracing is off unless a profiler is recording or :func:`enable` was
called. Off, :func:`span` costs one flag check and returns a shared null
context; :func:`add` the same check. On, a span is stored and mirrored
into the profiler's trace as an event of its name through
``torch._C._profiler._RecordFunctionFast``, which records only where the
profiler records CPU activity, and costs under a microsecond where it
records device activity alone, far less than
``torch.profiler.record_function``. A span's times exclude the tracer's own
bookkeeping. The autograd engine runs a CUDA backward on threads of its
own: a span that opens on a thread with no span open takes the span opened
with ``handoff=True`` (``train.backward``) as its parent.

The store keeps at least the last :data:`CAPACITY` spans, each packed into
one ``bytearray`` and a unit's ids and counters packed beside it as ints,
so that a span leaves behind no object the garbage collector counts:
:func:`records`, :func:`clear`, :func:`dump` (JSON lines).
:func:`idle_by_span` names a device's idle gaps by the deepest span open
when each began.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import json
import struct
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _mirror

from torch_nerf_tpu_torch.ops import launch_count

CAPACITY = 2**20
# a span: its name's number, id, parent, unit, thread, start, end (0: none)
_PACK = struct.Struct("7q")
_TRIM = 2 * CAPACITY * _PACK.size

FIELDS = ("name", "id", "parent", "unit", "tid", "start", "end", "attrs")
COUNTERS = ("layout_builds", "layout_bytes", "points")


class Record(collections.namedtuple("Record", FIELDS)):
    """One stored span; ``attrs`` holds a unit's ids and its ``counters``
    (None on other spans)."""

    __slots__ = ()

    def as_dict(self) -> dict:
        out = dict(zip(FIELDS[:-1], self[:-1]))
        if self.attrs:
            out.update(self.attrs)
        return out


class _State:
    """The process's tracer: whether :func:`enable` forced it on, the
    store (spans in ``buf``; a unit's ids and counters in ``attrs`` by its
    id, as packed ints: the number of ids, then (name's number, value)
    pairs, ids first), the names' numbers, this module's counters, the
    counted wrappers (only ever appended to), the span handed across
    threads and each thread's stack of open spans."""

    def __init__(self):
        self.forced = False
        self.lock = threading.RLock()  # new names, new wrappers and trimming
        self.buf = bytearray()
        self.attrs: Dict[int, bytes] = {}
        self.name_ids: Dict[str, int] = {}
        self.counts = [0] * len(COUNTERS)
        self.count_index = {name: i for i, name in enumerate(COUNTERS)}
        # the counted wrappers, and those counted by route, with the numbers
        # of their counters' names (this module's counters first)
        self.fns: list = []
        self.flat_names = [self.number(name) for name in COUNTERS]
        self.routed: list = []
        self.route_names: list = []
        self.handed: Optional[Span] = None
        self.local = threading.local()

    def number(self, name: str) -> int:
        nid = self.name_ids.get(name)
        if nid is None:
            with self.lock:
                nid = self.name_ids.setdefault(name, len(self.name_ids))
        return nid

    def wrappers(self) -> None:
        """List the wrappers :mod:`launch_count` has registered since."""
        with self.lock:
            for fn in list(launch_count.WRAPPERS.values())[len(self.fns):]:
                self.fns.append(fn)
                self.flat_names.append(self.number(fn.__name__))
                if hasattr(fn, "route_launches"):
                    self.routed.append(fn)
                    self.route_names.append({r: self.number(f"{fn.__name__}/{r}") for r in fn.route_launches})

    def trim(self) -> None:
        """Keep the last :data:`CAPACITY` spans, and the ids and counters
        of the units among them."""
        with self.lock:
            if len(self.buf) < _TRIM:
                return
            cut = CAPACITY * _PACK.size
            gone = set(memoryview(bytes(self.buf[:cut])).cast("q")[1::7].tolist())
            del self.buf[:cut]
            for sid in [sid for sid in self.attrs if sid in gone]:
                del self.attrs[sid]

    def clear(self) -> None:
        with self.lock:
            self.buf, self.attrs = bytearray(), {}


_S = _State()
_ids = itertools.count(1)
_pack = _PACK.pack
_time_ns = time.time_ns


def enable() -> None:
    """Record spans whether or not a profiler is recording."""
    _S.forced = True


def disable() -> None:
    """Record spans only while a profiler records (the default)."""
    _S.forced = False


def _attrs(packed: bytes, names: Dict[int, str]) -> dict:
    vals = memoryview(packed).cast("q").tolist()
    n_ids, pairs = vals[0], vals[1:]
    out = {names[k]: v for k, v in zip(pairs[0:2 * n_ids:2], pairs[1:2 * n_ids:2])}
    out["counters"] = {names[k]: v for k, v in zip(pairs[2 * n_ids::2], pairs[2 * n_ids + 1::2])}
    return out


def records() -> List[Record]:
    """The last :data:`CAPACITY` stored spans, in the order they ended."""
    with _S.lock:
        data, attrs = bytes(_S.buf[-CAPACITY * _PACK.size:]), dict(_S.attrs)
        names = {i: n for n, i in _S.name_ids.items()}
    return [Record(names[nid], sid, parent or None, unit_id or None, tid, start, end_ns,
                   _attrs(attrs[sid], names) if sid in attrs else None)
            for nid, sid, parent, unit_id, tid, start, end_ns in _PACK.iter_unpack(data)]


def clear() -> None:
    _S.clear()


def dump(path) -> None:
    """Write the store as JSON lines, one span a line."""
    with open(path, "w") as f:
        for r in records():
            f.write(json.dumps(r.as_dict()) + "\n")


def add(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (one of :data:`COUNTERS`) while
    tracing is on."""
    if _S.forced or _profiler._is_profiler_enabled:
        _S.counts[_S.count_index[name]] += n


def _snapshot() -> Tuple[list, list]:
    """This module's counters and each wrapper's launches, in one list
    (only ever longer); a copy of each routed wrapper's launches by
    route."""
    if len(_S.fns) != len(launch_count.WRAPPERS):
        _S.wrappers()
    return _S.counts + [fn.launches for fn in _S.fns], [fn.route_launches.copy() for fn in _S.routed]


def _counted(base: Tuple[list, list]) -> list:
    """(name's number, delta) of each counter that moved since ``base``,
    flat; a wrapper registered since counts from 0."""
    flat0, routes0 = base
    if len(_S.fns) != len(launch_count.WRAPPERS):
        _S.wrappers()
    flat = _S.counts + [fn.launches for fn in _S.fns]
    out = []
    if flat != flat0:
        flat0 = flat0 + [0] * (len(flat) - len(flat0))
        out += [x for k, a, b in zip(_S.flat_names, flat, flat0) if a != b for x in (k, a - b)]
    for j, fn in enumerate(_S.routed):
        now, was = fn.route_launches, routes0[j] if j < len(routes0) else {}
        if now != was:
            names = _S.route_names[j]
            out += [x for r, a in now.items() if a != was.get(r, 0) for x in (names[r], a - was.get(r, 0))]
    return out


class Span:
    """An open span, and its own context manager (:func:`span`,
    :func:`unit`)."""

    __slots__ = ("name", "id", "parent", "unit", "tid", "start", "ids", "handoff", "_mirror", "_handed", "_base")

    def __init__(self, name: str, handoff: bool = False, ids: Optional[dict] = None):
        self.name, self.handoff, self.ids = name, handoff, ids

    def __enter__(self) -> "Span":
        local = _S.local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
            local.tid = threading.get_native_id()
        up = stack[-1] if stack else _S.handed
        self.id = sid = next(_ids)
        self.tid = local.tid
        if up is None:
            self.parent = self.unit = 0
        else:
            self.parent, self.unit = up.id, up.unit
        if self.ids is not None:
            self.unit = sid
            self._base = _snapshot()
        if self.handoff:
            self._handed, _S.handed = _S.handed, self
        stack.append(self)
        m = self._mirror = _mirror(self.name)
        m.__enter__()
        self.start = _time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t = _time_ns()
        self._mirror.__exit__(None, None, None)
        stack = _S.local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self.handoff and _S.handed is self:
            _S.handed = self._handed
        if self.ids is not None:
            flat = [0]
            for k, v in self.ids.items():
                if v is not None:
                    flat += (_S.number(k), int(v))
            flat[0] = len(flat) // 2
            flat += _counted(self._base)
            _S.attrs[self.id] = struct.pack(f"{len(flat)}q", *flat)
        nid = _S.name_ids.get(self.name)
        buf = _S.buf
        buf += _pack(_S.number(self.name) if nid is None else nid, self.id, self.parent, self.unit, self.tid,
                     self.start, t)
        if len(buf) >= _TRIM:
            _S.trim()
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, handoff: bool = False):
    """A context manager recording the span ``name`` while tracing is on;
    ``handoff`` makes it the parent of spans opened on threads with no
    span open (the autograd engine's) while it is open."""
    if not (_S.forced or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, handoff)


def unit(kind: str, **ids):
    """A span that opens a unit of work; ``ids`` (ints, e.g. ``step=``;
    None is left out) are stored with it."""
    if not (_S.forced or _profiler._is_profiler_enabled):
        return _NULL
    return Span(kind, False, ids)


def backward_spans(chain) -> None:
    """Spans of a backward between gradient hooks: ``chain`` is ``[(tensor,
    name or None), ...]`` in the order their gradients arrive; each
    tensor's hook closes the span the previous one opened and opens
    ``name``. Registers nothing while tracing is off or where a tensor
    takes no gradient."""
    if not (_S.forced or _profiler._is_profiler_enabled):
        return
    if not torch.is_grad_enabled() or not all(t.requires_grad for t, _ in chain):
        return
    box: List[Optional[Span]] = [None]

    def hook_for(name):
        def hook(grad):
            if box[0] is not None:
                box[0].__exit__(None, None, None)
                box[0] = None
            if name is not None:
                box[0] = Span(name).__enter__()

        return hook

    for t, name in chain:
        t.register_hook(hook_for(name))


def idle_by_span(intervals: Sequence[Tuple[float, float]], spans: Iterable[dict],
                 window: Optional[Tuple[float, float]] = None) -> Tuple[float, Dict[str, float]]:
    """The device's busy time (the union of its ``(start, end)``
    ``intervals``) and its idle by the deepest of ``spans`` (dicts with
    ``id``, ``parent``, ``name``, ``start``, ``end``, on the intervals'
    clock; depth by parent links, across threads; the later start between
    equals) open when each gap began, ``-`` where none was, within
    ``window`` (default: the first interval's start to the last's end)."""
    lo, hi = window or (min(a for a, _ in intervals), max(b for _, b in intervals))
    spans = sorted(spans, key=lambda s: s["start"])
    by_id = {s["id"]: s for s in spans}
    depth: Dict[int, int] = {}
    for s in spans:
        chain = []
        while s is not None and s["id"] not in depth:
            chain.append(s)
            s = by_id.get(s["parent"])
        d = depth[s["id"]] if s is not None else -1
        for c in reversed(chain):
            d += 1
            depth[c["id"]] = d
    starts = [s["start"] for s in spans]
    reach, longest = [], 0.0  # the longest span up to each index bounds how far back an open one starts
    for s in spans:
        longest = max(longest, s["end"] - s["start"])
        reach.append(longest)

    def deepest(t):
        i = bisect.bisect_right(starts, t)
        best = None
        for s in spans[bisect.bisect_left(starts, t - reach[i - 1]) if i else 0:i]:
            if s["end"] > t and (best is None or depth[s["id"]] >= depth[best["id"]]):
                best = s
        return best

    busy, idle, t = 0.0, collections.defaultdict(float), lo
    for a, b in sorted(intervals) + [(hi, hi)]:
        a, b = min(max(a, lo), hi), min(b, hi)
        if a > t:
            s = deepest(t)
            idle[s["name"] if s is not None else "-"] += a - t
        busy += max(0.0, b - max(a, t))
        t = max(t, b)
    return busy, dict(idle)
