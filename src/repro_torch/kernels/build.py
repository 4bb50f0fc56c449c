"""Build the CUDA sources under ``repro_torch/csrc`` at first use and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper and loaded with ``ctypes``. Every source
includes ``csrc/parts.cuh`` and is compiled once per part, each part's
kernels on their own ``nvcc``, and the objects are linked into the library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC -Xptxas=-v -DREPRO_PART=<p>
         -o build/repro_torch/<name>-<hash>.p<p>.o <name>.cu   (each p at once)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/repro_torch/<name>-<hash>.so <the part objects>

The library name carries a hash of the source, of the shared headers
``csrc/*.cuh`` and of the flags, so an edited source or header rebuilds and
an unchanged one is reused. The build directory is
``build/repro_torch/`` at the root of the checkout (``.gitignore`` lists
``build/``); the compilers' output, with ptxas' registers and spills per
kernel, stays beside each library as ``<name>-<hash>.log``. ``build_all``
starts every ``nvcc`` of every source at once. A failed build raises with
the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

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


def parts() -> int:
    """How many ``nvcc`` build each source: ``REPRO_PARTS`` of
    ``csrc/parts.cuh``."""
    return int(re.search(r"#define REPRO_PARTS (\d+)",
                         (CSRC / "parts.cuh").read_text()).group(1))


def _run(cmd, log_path: Path) -> subprocess.Popen:
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def _start(name: str):
    """Start every ``nvcc`` of ``csrc/<name>.cu``; None when already built."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = str(CSRC / f"{name}.cu")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".p{p}.{os.getpid()}.o") for p in range(parts())]
    logs = [o.with_suffix(".log") for o in objs]
    procs = [_run([nvcc_path(), *NVCC_FLAGS, "-c", f"-DREPRO_PART={p}",
                   "-o", str(o), src], lg)
             for p, (o, lg) in enumerate(zip(objs, logs))]
    return procs, logs, objs, tmp, out


def _finish(name: str, job) -> None:
    """Wait for ``_start``'s compilers, link the parts, and put the library
    and the compilers' output (every part's, in order) in place."""
    procs, logs, objs, tmp, out = job
    rcs = [p.wait() for p in procs]
    if not any(rcs):
        logs.append(out.with_suffix(f".link.{os.getpid()}.log"))
        link = _run([nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                     *map(str, objs)], logs[-1])
        rcs.append(link.wait())
    text = "".join(lg.read_text() for lg in logs if lg.is_file())
    for path in (*logs, *objs):
        path.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(text)
    if any(rcs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu (exits {rcs}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file


def build_all(names=None) -> dict:
    """Build every (or the named) ``csrc/*.cu``, every ``nvcc`` at once;
    returns the libraries' paths."""
    names = list(names) if names is not None else sorted(
        p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start(n) for n in names}
    try:
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    finally:  # a failed build leaves no compiler running, and no part
        for job in jobs.values():
            if job is None:
                continue
            procs, logs, objs = job[:3]
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for path in (*logs, *objs):
                path.unlink(missing_ok=True)
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
