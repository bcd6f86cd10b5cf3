"""Run one cell once and print its result line.

    python3 -m nerfbench.run --workload nerf_blender.train --seed 7 --seconds 10 --trace 0

From the root of a checkout. Set-up (imports, the kernels' build on a first
run, inputs, warm-up) is timed from the start of this module. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a profiled stretch after the window. Every run compares what the timed
path produced with the plain reference and prints each number compared
beside its limit, on standard error and last in the result line. Exits
non-zero, printing no result, without enough CUDA cards, or if JAX or the
JAX package was loaded.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """One run of ``cell``: the result line's object."""
    import torch

    from nerfbench import check, jobs, spec, trace as tracing

    run = jobs.run(cell, seed, seconds, traced, device, t_start)
    chosen = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": False, "attempted": run.units, "failed": 0, "metrics": metrics, "device": dev}
    print(f"setup: {json.dumps(run.setup_phases)} s since the start; setup_s {run.setup_s!r}", file=sys.stderr)
    if traced and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s(), run.trace.window_s
        result["breakdown"] = tracing.breakdown(run.trace, run.span_trace)
        print(f"trace: {run.traced_units} units in {run.traced_s!r} s profiled (device only) against "
              f"{run.window_s / run.units!r} s a unit unprofiled; {run.span_trace.unlaunched} of "
              f"{len(run.span_trace.ops)} device operations without a launch record", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ok, table = check.verdict(check.readings(run), cell.limits)
    result["correct"] = ok
    result["failed"] = sum(1 for e in table.values() if not e["value"] <= e["limit"])
    result["check"] = table
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from nerfbench import guard, spec

    cell = spec.find(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"nerfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), _T_START)
    found = guard.banned_loaded()
    if found:
        print(f"nerfbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, e in result["check"].items():
        print(f"check {name} {e['value']!r} limit {e['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
