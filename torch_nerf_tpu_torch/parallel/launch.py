"""Run a function on N ranks, one spawned process each, and collect what
they return.

``spawn(fn, world_size, work_dir, args)`` starts ``fn(rank, world_size,
init_method, *args)`` in ``world_size`` fresh processes (the ``spawn``
start method; ``fn`` must be importable by its module path), with
``init_method`` a ``file://`` rendezvous under ``work_dir``, so that
concurrent launches never share a port. It returns the ranks' results in
rank order. A rank that raises, or exits non-zero, fails the launch: the
other ranks are killed and :class:`RankFailed` carries the rank's
traceback. A launch that outlasts ``timeout`` seconds is killed and raises
``TimeoutError``. No rank's error is swallowed.
"""

from __future__ import annotations

import multiprocessing
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch


class RankFailed(RuntimeError):
    """A rank of a :func:`spawn` raised or exited non-zero."""


def _run_rank(fn, rank: int, world_size: int, init_method: str, out: str, threads: Optional[int], args) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        result = fn(rank, world_size, init_method, *args)
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise
    import torch.distributed as dist  # noqa: PLC0415

    if dist.is_initialized():
        dist.destroy_process_group()
    torch.save(result, out)


def spawn(fn: Callable, world_size: int, work_dir, args: Sequence[Any] = (), timeout: float = 300.0,
          threads: Optional[int] = None) -> List[Any]:
    """``fn(rank, world_size, init_method, *args)`` on ``world_size``
    spawned ranks -> their results in rank order (each saved with
    ``torch.save`` and loaded here). ``threads`` sets each rank's
    ``torch.set_num_threads``."""
    Path(work_dir).mkdir(parents=True, exist_ok=True)
    run_dir = Path(tempfile.mkdtemp(prefix="spawn_", dir=work_dir))
    init_method = f"file://{run_dir / 'rendezvous'}"
    outs = [str(run_dir / f"rank{r}.pt") for r in range(world_size)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_run_rank, args=(fn, r, world_size, init_method, outs[r], threads, tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs) and not any(p.exitcode not in (None, 0) for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size}-rank launch of {fn.__name__} outlasted {timeout} s")
            time.sleep(0.05)
        time.sleep(0.5 if any(p.is_alive() for p in procs) else 0.0)  # let the others' errors land
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed:
            raise RankFailed("\n".join(_failure(r, procs[r].exitcode, outs[r]) for r in failed))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
    return [torch.load(out, weights_only=False) for out in outs]


def _failure(rank: int, exitcode: int, out: str) -> str:
    err = Path(out + ".err")
    detail = err.read_text() if err.exists() else "(no traceback written)"
    return f"rank {rank} exited with code {exitcode}:\n{detail}"
