"""Time ``chip_smoke.py`` of several checkouts phase by phase, on one card.

For each checkout root in turn it runs ``python3 -u chip_smoke.py`` there,
writes its standard output to ``OUT/<root's name>.log`` with each line
prefixed by the seconds since that run started (``"%.1f <line>"``) and
its standard error to ``OUT/<name>.err``. Then it prints, for each phase
line (``{"phase": ...}``) of the first root, the seconds since the line
before it in each root's log, and each run's total. A phase line arrives
when its phase ends, so the seconds are the phase's, set-up included.
Older checkouts print no ``elapsed_s``; the stamps time every checkout
alike. ``--tally-only`` reads logs already written.

    python -m torch_nerf_tpu_torch.runners.smoke_ab --out DIR ROOT [ROOT ...] [--timeout S] [--tally-only]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple


def run(root: Path, out: Path, timeout: float) -> int:
    """``chip_smoke.py`` in ``root``, its stdout stamped into ``out/<name>.log``."""
    t0 = time.time()
    with open(out / f"{root.name}.log", "w") as log, open(out / f"{root.name}.err", "w") as err:
        proc = subprocess.Popen(["timeout", str(int(timeout)), sys.executable, "-u", "chip_smoke.py"], cwd=root,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        for line in proc.stdout:
            log.write(f"{time.time() - t0:.1f} {line}")
            log.flush()
        return proc.wait()


def phases(log: Path) -> List[Tuple[str, float, float]]:
    """``(phase, seconds at its line, seconds since the line before)`` of a log."""
    out, prev = [], 0.0
    for line in log.read_text().splitlines():
        stamp, _, rest = line.partition(" ")
        if not rest.startswith('{"phase"'):
            continue
        try:
            phase = json.loads(rest)["phase"]
        except ValueError:
            continue
        out.append((phase, float(stamp), float(stamp) - prev))
        prev = float(stamp)
    return out


def tally(out: Path, names: List[str]) -> Dict[str, dict]:
    runs = {name: phases(out / f"{name}.log") for name in names}
    first = names[0]
    table = {}
    for phase, _, _ in runs[first]:
        table[phase] = {name: next((s for p, _, s in runs[name] if p == phase), None) for name in names}
    for phase, row in table.items():
        print(json.dumps({"phase": phase, "seconds": row}))
    totals = {name: (runs[name][-1][1] if runs[name] else None) for name in names}
    print(json.dumps({"total_seconds": totals}))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds a run may take")
    ap.add_argument("--tally-only", action="store_true")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    rcs = {}
    if not args.tally_only:
        for root in args.roots:
            rcs[root.name] = run(root.resolve(), args.out, args.timeout)
            print(json.dumps({"root": str(root), "rc": rcs[root.name]}), flush=True)
    tally(args.out, [root.name for root in args.roots])
    return max(rcs.values(), default=0)


if __name__ == "__main__":
    sys.exit(main())
