"""Build the CUDA sources under ``repro_torch/csrc`` at first use and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/repro_torch/<name>-<hash>.so
         <name>.cu

The library name carries a hash of the source, of the shared headers
``csrc/*.cuh`` and of the flags, so an edited source or header rebuilds and
an unchanged one is reused. The build directory is
``build/repro_torch/`` at the root of the checkout (``.gitignore`` lists
``build/``); the compiler's output, with ptxas' registers and spills per
kernel, stays beside each library as ``<name>-<hash>.log``. ``build_all``
starts one ``nvcc`` per source, all at once. A failed build raises with the
compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict = {}  # name -> ctypes.CDLL loaded in this process


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda); "
        "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is built (content-keyed: the
    source, every shared header ``csrc/*.cuh`` and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu``; None when already built."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish(name: str, job) -> None:
    proc, log, tmp, out = job
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu (exit {rc}):\n"
            + out.with_suffix(".log").read_text())
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file


def build_all(names=None) -> dict:
    """Build every (or the named) ``csrc/*.cu`` in parallel; returns paths."""
    names = list(names) if names is not None else sorted(
        p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start(n) for n in names}
    try:
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    finally:  # a failed build leaves no compiler running
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
