"""``runners/smoke_ab.py``: each checkout's ``chip_smoke.py`` run in turn,
its output lines stamped, and the seconds tallied by phase."""

import json

from torch_nerf_tpu_torch.runners import smoke_ab

FAKE = """import json, sys, time
for phase in ("build", "kernel"):
    time.sleep(0.2)
    print(json.dumps({"phase": phase, "ok": True}))
print("not a phase line")
print("oops", file=sys.stderr)
sys.exit(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
"""


def test_runs_each_root_and_tallies_its_phases(tmp_path, capsys):
    roots = []
    for name in ("change", "parent"):
        root = tmp_path / name
        root.mkdir()
        (root / "chip_smoke.py").write_text(FAKE)
        roots.append(root)
    out = tmp_path / "out"
    assert smoke_ab.main(["--out", str(out), *map(str, roots)]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["rc"] for line in lines[:2]] == [0, 0]
    table = {line["phase"]: line["seconds"] for line in lines if "phase" in line}
    assert list(table) == ["build", "kernel"]
    for name in ("change", "parent"):
        assert 0.1 < table["build"][name] < 30 and 0.1 < table["kernel"][name] < 30
        assert (out / f"{name}.err").read_text() == "oops\n"
        stamps = [line.split(" ", 1) for line in (out / f"{name}.log").read_text().splitlines()]
        assert [rest for _, rest in stamps][-1] == "not a phase line"
        assert all(float(s) >= 0 for s, _ in stamps)
    assert set(lines[-1]["total_seconds"]) == {"change", "parent"}


def test_tally_reads_written_logs_and_marks_a_missing_phase(tmp_path, capsys):
    (tmp_path / "a.log").write_text('1.0 {"phase": "build"}\n3.5 {"phase": "new"}\n4.0 {"phase": "kernel"}\n'
                                    '4.0 {"ok": true}\n')
    (tmp_path / "b.log").write_text('2.0 {"phase": "build"}\n2.5 {"phase": "kernel"}\n')
    table = smoke_ab.tally(tmp_path, ["a", "b"])
    assert table == {"build": {"a": 1.0, "b": 2.0}, "new": {"a": 2.5, "b": None}, "kernel": {"a": 0.5, "b": 0.5}}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"total_seconds": {"a": 4.0, "b": 2.5}}
