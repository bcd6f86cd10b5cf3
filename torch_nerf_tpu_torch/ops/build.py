"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``torch_nerf_tpu_torch/
_build/`` (git-ignored). The library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale one never
loaded. Nothing is built when a module is imported: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build_sources(sources: Iterable[Path]) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    each, all started together. Returns ``{source: compiler output}`` for
    the sources built now (``-Xptxas -v``: registers, spills). Raises with
    the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    reports: Dict[str, str] = {}
    failures = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {src} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        tmp.replace(out)
        reports[str(src)] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def build(names: Iterable[str]) -> Dict[str, str]:
    """:func:`build_sources` for ``csrc/<name>.cu`` of each name."""
    return build_sources(source(n) for n in names)


def load_source(src: Path) -> ctypes.CDLL:
    """The built library of ``src`` (built first if needed)."""
    path = library_path(src)
    lib = _loaded.get(path)
    if lib is None:
        build_sources([src])
        lib = ctypes.CDLL(str(path))
        _loaded[path] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``."""
    return load_source(source(name))
