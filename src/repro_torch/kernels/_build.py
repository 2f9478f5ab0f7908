"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file exposes plain C entry points (pointers, sizes and the
stream as ``void*``/``int``) and is compiled on its own by ``nvcc`` into
``build/kernels/<stem>-<hash>.so`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``. The file name carries a hash of
every file in the source's ``csrc/`` directory (headers included) and the
flags, so an edited kernel or header rebuilds and a stale library is never
loaded. Nothing here runs at import time: the first wrapper call that
needs a kernel builds it; :func:`build_all` starts every ``nvcc`` at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v")

# every CUDA source of the package, by short name
SOURCES = {
    "segment_agg": _PKG / "segment_agg" / "csrc" / "segment_agg.cu",
    "segment_graph": _PKG / "segment_agg" / "csrc" / "segment_graph.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "embedding_bag": _PKG / "embedding_bag" / "csrc" / "embedding_bag.cu",
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas register/shared-memory report of each build, by short name
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels build from source at "
                           "first use")
    return found


def _target(name: str) -> Path:
    """The library's path, named by a hash of every file in the source's
    ``csrc/`` directory (the ``.cu`` and the headers it includes) and the
    flags."""
    h = hashlib.sha256()
    for f in sorted(p for p in SOURCES[name].parent.iterdir() if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc into a temporary file; ``None`` if already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp,
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a torn .so


def _load(names) -> None:
    """Build the named sources that are not loaded yet, every ``nvcc``
    started before any is waited for, and load them. Called under
    ``_lock``."""
    todo = {n: _start(n) for n in names if n not in _libs}
    for n, started in todo.items():
        if started is not None:
            _finish(n, started)
        _libs[n] = ctypes.CDLL(str(_target(n)))


def build_all() -> None:
    """Compile every CUDA source of the package in parallel (one ``nvcc``
    per source, all started together) and load the libraries."""
    with _lock:
        _load(SOURCES)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one CUDA source, built on first use."""
    if name not in _libs:
        with _lock:
            _load([name])
    return _libs[name]
