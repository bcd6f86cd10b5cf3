"""The device trace of the traced stretch: ``torch.profiler`` with CPU and
CUDA activity, exported as a Chrome trace and read back.

Every device operation (kernel, copy, fill) is tied to the host call that
launched it by the trace's correlation id, and so to the benchmark's
spans that were open on the launching thread at that moment. The busy
time is the union of the device operations' intervals inside the window
(two streams at once count once); an idle gap is named by the innermost
span open on the window's thread when the gap began.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from nerfbench.spans import PREFIX

WINDOW = "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float  # seconds
    end: float
    spans: frozenset


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]
    ops: List[DeviceOp]
    spans: List[Tuple[str, int, float, float]]  # (name, tid, start, end)
    window_tid: int
    unlaunched: int  # device operations with no launch found

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[DeviceOp]:
        """The kernels of the stretch, without its two markers."""
        ks = sorted((op for op in self.ops if op.cat == "kernel"), key=lambda op: op.start)
        return ks[1:-1]

    def device_time(self, span_names) -> Optional[float]:
        """Seconds of every device operation launched inside any of
        ``span_names``; None where none was."""
        want = set(span_names)
        ops = [op for op in self.ops if op.spans & want]
        return sum(op.end - op.start for op in ops) if ops else None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        merged: List[List[float]] = []
        for a, b in sorted((max(op.start, lo), min(op.end, hi)) for op in self.ops):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the window by the innermost span open on the
        window's thread when each gap began (spans on one thread nest)."""
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if a > t:
                gaps.append((t, a - t))
            t = max(t, b)
        opened = sorted((a, -b, name) for name, tid, a, b in self.spans
                        if tid == self.window_tid and name != WINDOW)
        out: Dict[str, float] = collections.defaultdict(float)
        stack: List[Tuple[float, str]] = []
        i = 0
        for g, length in gaps:
            while i < len(opened) and opened[i][0] <= g:
                a, neg_b, name = opened[i]
                while stack and stack[-1][0] <= a:
                    stack.pop()
                stack.append((-neg_b, name))
                i += 1
            while stack and stack[-1][0] <= g:
                stack.pop()
            out[stack[-1][1] if stack else WINDOW] += length
        return dict(out)

    def ops_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for op in self.ops:
            out[op.name] += op.end - op.start
        return dict(out)


def record(fn: Callable[[], None], with_spans: bool) -> Tuple[dict, float]:
    """Run ``fn`` under the profiler, between two marker fills launched
    right after a synchronize and right before the last one, so that the
    device's first and last operations bound the stretch: ``(the Chrome
    trace as a dict, the stretch's host seconds)``. ``with_spans`` adds CPU activity, which records the spans
    and the launches' host calls at a cost to the host of every operation;
    without it only the device's activity is recorded."""
    acts = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if with_spans or not acts:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    marker = torch.empty(1, device="cuda" if torch.cuda.is_available() else "cpu")
    _sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(PREFIX + WINDOW):
            t0 = time.perf_counter()
            marker.fill_(0.0)
            fn()
            marker.fill_(1.0)
            _sync()
            seconds = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f), seconds
    finally:
        os.unlink(path)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def summarize(chrome: dict) -> Trace:
    events = chrome.get("traceEvents", [])
    spans, launches, device = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0.0)) * 1e-6
        if cat == "user_annotation" and str(ev.get("name", "")).startswith(PREFIX):
            spans.append((ev["name"][len(PREFIX):], ev.get("tid"), ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (ev.get("tid"), ts)
        elif cat in DEVICE_CATS:
            device.append((ev.get("name", "?"), cat, ts, ts + dur, args.get("correlation")))
    windows = [s for s in spans if s[0] == WINDOW]
    wtid = windows[0][1] if windows else None
    if device:  # the markers bound the stretch on the device's clock
        w0, w1 = min(a for _, _, a, _, _ in device), max(b for _, _, _, b, _ in device)
    elif windows:
        w0, w1 = windows[0][2], windows[0][3]
    else:
        raise RuntimeError("the trace holds neither device operations nor a window span")
    ops = [DeviceOp(name, cat, a, b, frozenset()) for name, cat, a, b, _ in device]
    by_tid: Dict = collections.defaultdict(list)
    unlaunched = 0
    for i, (_, _, _, _, corr) in enumerate(device):
        launch = launches.get(corr)
        if launch is None:
            unlaunched += 1
        else:
            by_tid[launch[0]].append((launch[1], i))
    for tid, items in by_tid.items():
        opened = sorted((a, -b, name) for name, t, a, b in spans if t == tid)
        stack: List[Tuple[float, str]] = []
        j = 0
        for t, i in sorted(items):
            while j < len(opened) and opened[j][0] <= t:
                a, neg_b, name = opened[j]
                while stack and stack[-1][0] <= a:
                    stack.pop()
                stack.append((-neg_b, name))
                j += 1
            while stack and stack[-1][0] <= t:
                stack.pop()
            ops[i].spans = frozenset(name for _, name in stack)
    return Trace((w0, w1), ops, spans, wtid, unlaunched)


def breakdown(device: Trace, with_spans: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (the device-only pass)
    and the idle seconds by the span open when each gap began (the pass
    with spans, whose host runs slower under the profiler)."""
    ops = sorted(device.ops_by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(with_spans.idle_by_span().items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
