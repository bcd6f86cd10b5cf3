"""The kernels' build (``torch_nerf_tpu_torch/ops/build.py``) on the CPU, with
a stand-in compiler: a shell script in place of ``nvcc`` that records its
arguments and writes the file ``-o`` names. A source is one library; a
source with parts (``<name>.<part>.cu``) is one object a unit, all started
together, linked into that library; the library's name follows every unit,
so an edited part is rebuilt.
"""

import stat

import pytest

from torch_nerf_tpu_torch.ops import build

FAKE_NVCC = """#!/bin/sh
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "nvcc $*" >> "$(dirname "$0")/calls.log"
case "$*" in *broken.cu*) echo "error: broken"; exit 2;; esac
echo "ptxas info    : Used 1 registers"
touch "$out"
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "one.cu").write_text("one")
    (csrc / "two.cu").write_text("two")
    (csrc / "two.f32.cu").write_text("two, f32")
    return csrc, tmp_path / "calls.log"


def test_each_tensor_core_source_has_its_f32_part():
    for name in ("fused_tc_fwd", "fused_tc_bwd", "fused_tc_train"):
        units = build.parts(build.source(name))
        assert [u.name for u in units] == [f"{name}.cu", f"{name}.f32.cu"]
    assert build.parts(build.source("fused_nerf_fwd")) == [build.source("fused_nerf_fwd")]


def test_a_source_with_parts_is_compiled_a_unit_at_a_time_and_linked(fake):
    csrc, calls = fake
    reports = build.build_sources([csrc / "one.cu", csrc / "two.cu"])
    assert sorted(reports) == [str(csrc / "one.cu"), str(csrc / "two.cu")]
    log = calls.read_text().splitlines()
    one = [c for c in log if c.endswith("one.cu")]
    assert len(one) == 1 and "-shared" in one[0].split() and "-c" not in one[0].split()
    units = [c for c in log if " -c " in c]
    assert sorted(c.split()[-1].rsplit("/", 1)[1] for c in units) == ["two.cu", "two.f32.cu"]
    assert all("-shared" not in c.split() for c in units)
    link = [c for c in log if c.split()[1] == "-shared"]
    assert len(link) == 1 and link[0].count(".o") == 2
    built = sorted(p.name for p in build.BUILD_DIR.iterdir())
    assert len(built) == 2 and all(n.endswith(".so") for n in built)  # the objects are gone
    # built once: nothing to do the second time
    assert build.build_sources([csrc / "one.cu", csrc / "two.cu"]) == {}


def test_an_edited_part_names_a_new_library(fake):
    csrc, _ = fake
    before = build.library_path(csrc / "two.cu")
    (csrc / "two.f32.cu").write_text("two, f32, edited")
    assert build.library_path(csrc / "two.cu") != before
    assert build.library_path(csrc / "one.cu").name.startswith("libone-")


def test_a_failed_unit_raises_with_the_compiler_output(fake):
    csrc, _ = fake
    (csrc / "two.broken.cu").write_text("broken")
    with pytest.raises(RuntimeError, match="error: broken"):
        build.build_sources([csrc / "two.cu"])
    assert not build.library_path(csrc / "two.cu").exists()
