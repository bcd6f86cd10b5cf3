"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``torch_nerf_tpu_torch/
_build/`` (git-ignored). The library's file name carries a hash of its
source, the ``*.cuh`` headers beside it and the flags, so an edited source
is rebuilt and a stale one never loaded. Nothing is built when a module is imported: the CPU tests import
every module on a machine without ``nvcc``. A source may have parts,
``<name>.<part>.cu`` beside it (the tensor-core general route's f32
kernels, apart from its bf16 ones): each is compiled to an object by an
``nvcc`` of its own, all started together, and the objects are linked
into the one library. (nvcc's ``--split-compile``, which compiles a
source's kernels in parallel too, made path A's kernel 3 13% slower on
the card.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[Path, ctypes.CDLL] = {}
_by_name: Dict[str, ctypes.CDLL] = {}


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


def parts(src: Path) -> List[Path]:
    """The translation units of ``src``'s library: ``src`` and its parts,
    ``<name>.<part>.cu`` beside it."""
    return [src] + sorted(src.parent.glob(f"{src.stem}.*.cu"))


def library_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of it and its parts, the
    headers beside it and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    units = b"".join(u.read_bytes() for u in parts(src))
    digest = hashlib.sha256(units + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def _run(procs) -> List[Tuple[int, str]]:
    """Each process's exit code and output, once it has ended."""
    out = []
    for p in procs:
        text = p.communicate()[0]
        out.append((p.returncode, text))
    return out


def build_sources(sources: Iterable[Path]) -> Dict[str, str]:
    """Compile every source that has no up-to-date library: a source of
    one translation unit by one ``nvcc``, a source with parts by one
    ``nvcc -c`` a unit and a link; every compile started together. Returns
    ``{source: compiler output}`` for the sources built now (``-Xptxas
    -v``: registers, spills). Raises with the compiler's output on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler, tag = nvcc(), os.getpid()
    jobs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f".{out.name}.{tag}.tmp")
        units = parts(src)
        if len(units) == 1:
            cmds, objs = [[compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]], []
        else:
            objs = [tmp.with_name(f".{u.stem}.{tag}.o") for u in units]
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            cmds = [[compiler, *flags, "-c", "-o", str(o), str(u)] for u, o in zip(units, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
        jobs.append((src, out, tmp, objs, procs))
    reports: Dict[str, str] = {}
    failures = []
    for src, out, tmp, objs, procs in jobs:
        results = _run(procs)
        log = "".join(text for _, text in results)
        if objs and all(rc == 0 for rc, _ in results):
            link = subprocess.run([compiler, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
            results.append((link.returncode, link.stdout + link.stderr))
            log += link.stdout + link.stderr
        for o in objs:
            o.unlink(missing_ok=True)
        if any(rc != 0 for rc, _ in results):
            failures.append(f"nvcc failed for {src}:\n{log}")
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
    """The built library for ``csrc/<name>.cu``. The sources are hashed at a
    process's first call only: a wrapper calls this at every launch, and
    reading and hashing ~60 KB of sources each time is host time a short
    kernel (a hash-grid forward) waits for."""
    lib = _by_name.get(name)
    if lib is None:
        lib = _by_name[name] = load_source(source(name))
    return lib
