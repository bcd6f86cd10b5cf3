"""Cells from files, by name: ``BENCHMARK.json`` lists the cells and the
metrics; a cell's configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json``, the limits of its comparison
``limits/<cell>.json``, and each metric is read by ``metrics/<metric>.py``
(a function ``read(run) -> float or None``). A later cell, mix or metric
is new files and new entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

PORT_GROUPS = ("device.", "network.", "signal_encoder.", "renderer.", "train_params.", "objective.", "occupancy.",
               "parallel.")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def job(self) -> str:
        return self.traffic["job"]

    def port_overrides(self) -> List[str]:
        """The configuration's port keys as ``key=value`` overrides."""
        out = []
        for key, value in self.config.items():
            if key.startswith(PORT_GROUPS):
                text = json.dumps(value) if not isinstance(value, str) else value
                out.append(f"{key}={text}")
        return out


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(name: str, root: Path = ROOT, bench: Optional[Dict] = None) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; workloads: {[w['name'] for w in bench['workloads']]}")
    w = entries[0]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = HERE / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    # an end-to-end metric without ``workloads`` is every cell's; a per-layer metric names its cells
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, w["config"], w["traffic"], w["chips"], config, traffic, limits, e2e, per_layer)


def reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``, loaded by path (a metric's name
    may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"nerfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
