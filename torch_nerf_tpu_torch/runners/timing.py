"""Timing helpers of the measurement runners and ``chip_smoke.py``."""

from __future__ import annotations

import contextlib
import statistics
import subprocess

import torch


def event_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up (CUDA
    events on the current stream)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query>`` of card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def kernel_library(module, lib):
    """Route ``module``'s kernel launches through the library ``lib`` inside
    the block (the module looks its library up through ``_library``)."""
    saved = module._library
    module._library = lambda: lib
    try:
        yield
    finally:
        module._library = saved


def quartiles(xs) -> dict:
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2], "n": len(xs)}
