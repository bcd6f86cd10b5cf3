"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared whole at
their top level: ``torch_nerf_tpu_torch`` is the port, not
``torch_nerf_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from nerfbench import guard, spec

PKG = spec.HERE
BANNED = set(guard.BANNED)


def imported(path: Path):
    """Top-level names of every module ``path`` imports (absolute
    imports; relative ones stay inside the package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return guard.top_levels(names)


def test_top_level_comparison_is_whole():
    assert guard.banned_loaded(["torch_nerf_tpu_torch.train", "torch"]) == []
    assert guard.banned_loaded(["torch_nerf_tpu.train"]) == ["torch_nerf_tpu"]
    assert guard.banned_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not imported(path) & BANNED, path


def test_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").rglob("*.py"):
        names = imported(path)
        assert "torch_nerf_tpu_torch" not in names, path
        assert names <= {"__future__", "importlib", "typing", "numpy", "torch", "nerfbench", "math"}, (path, names)


def test_span_table_names_only_the_port():
    from nerfbench import spans

    for entry in spans.table().values():
        assert entry["module"].split(".")[0] == "torch_nerf_tpu_torch"


def test_what_a_run_imports():
    """Everything a run and the reference import, walked in a fresh
    process: no JAX, no JAX package; the reference alone loads no port."""
    metrics = json.dumps([p.stem for p in (PKG / "metrics").glob("*.py") if not p.stem.startswith("_")])
    code = f"""
import json, sys
sys.path.insert(0, {str(spec.ROOT)!r})
import nerfbench.reference, nerfbench.reference.nerf, nerfbench.reference.ngp, nerfbench.reference.optim
ref_only = sorted({{n.split('.')[0] for n in sys.modules}})
import nerfbench.run, nerfbench.jobs, nerfbench.check, nerfbench.calibrate, nerfbench.faults
from nerfbench import spec, spans
for m in json.loads({metrics!r}):
    spec.reader(m)
import importlib
for e in spans.table().values():
    importlib.import_module(e['module'])
print(json.dumps([ref_only, sorted({{n.split('.')[0] for n in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ref_only, everything = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch_nerf_tpu_torch" not in ref_only
    assert not set(everything) & BANNED
    assert "torch_nerf_tpu_torch" in everything
