"""The readings a cell's limits are set from, in one process on the card:

    python3 -m nerfbench.calibrate --workload nerf_blender.train --seeds 12 --control 3 --faults 3 --out FILE

For each of ``--seeds`` seeds, the program's readings at the cell's own
size (the checked steps of a train cell; a render cell's first frame and
as many chunks as a run compares); on the first ``--control`` of them, the
control's (the reference with fp8 operands in the program's place); and
for each planted fault (``faults.py``) on ``--faults`` seeds, the faulty
program's. A number's limit lies above the largest sound reading and below
the least control or fault reading that is three times it or more.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2**31 + 1000)
    p.add_argument("--seed-list", default=None, help="comma-separated seeds, in place of --seeds and --first-seed")
    p.add_argument("--override", action="append", default=[],
                   help="KEY=VALUE of the port's configuration, for a witness (parallel.use_pallas=false: the "
                        "plain path; device.compute_dtype=float32)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from nerfbench import check, faults, jobs, spec
    from nerfbench.reference import lowp

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.find(args.workload)
    for item in args.override:
        key, value = item.split("=", 1)
        try:
            cell.config[key] = json.loads(value)
        except ValueError:
            cell.config[key] = value
    device = torch.device("cuda", 0)
    out = {"workload": cell.name, "card": torch.cuda.get_device_name(0), "overrides": args.override, "program": [],
           "control": [], "faults": {name: [] for name in faults.NAMES}}
    if args.seed_list:
        seeds = [int(x) for x in args.seed_list.split(",")]
    else:
        seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run = jobs.run(cell, seed, 0.0, False, device, time.perf_counter())
        out["program"].append({"seed": seed, **check.readings(run)})
        if i < args.control:
            out["control"].append({"seed": seed, **check.readings(run, lowp.fp8, as_program=False)})
        del run
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s {out['program'][-1]}", file=sys.stderr, flush=True)
    for name in faults.NAMES:
        for seed in seeds[:args.faults]:
            with faults.planted(cell.job, name):
                run = jobs.run(cell, seed, 0.0, False, device, time.perf_counter())
            out["faults"][name].append({"seed": seed, **check.readings(run)})
            del run
            torch.cuda.empty_cache()
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
