"""Cells are found from files by name, and ``BENCHMARK.json`` keeps the
rules of its names, units and keys."""

import json
import re

import pytest

from nerfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for path in BENCH["paths"]:
        assert (spec.ROOT / path).is_dir()


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_from_files(name):
    cell = spec.find(name)
    assert cell.name == name
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["job"] in ("train", "render")
    assert cell.chips == 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    for key, value in cell.limits.items():
        assert value > 0, key


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find("no_such.cell")


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(set(names)) == len(names)


def test_metrics_keys_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("higher", "lower")
        for cell in m.get("workloads", []):
            moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
            assert cell in moved.get("workloads", CELLS)


def test_config_files_are_json_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("nerfbench/")
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])


def test_port_overrides_cover_every_port_key():
    cell = spec.find("nerf_blender.train")
    over = dict(o.split("=", 1) for o in cell.port_overrides())
    assert over["network.feat_dim"] == "256"
    assert over["signal_encoder.include_input"] == "true"
    assert "scene" not in over and "widths" not in over
