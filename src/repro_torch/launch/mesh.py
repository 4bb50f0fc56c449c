"""Meshes of ranks over torch.distributed, and a launcher that spawns them.

Port of ``repro/launch/mesh.py``. A JAX program sees every device of a
mesh from one process; here each rank is a process holding its own block
of every sharded tensor, and a ``Mesh`` names its axes ("data", "model"),
their sizes (``mesh.shape``, a dict, as the reference reads it), the
calling rank's coordinate on each (``mesh.index(axis)``) and the process
group of each axis (``mesh.group(axis)``), over
``torch.distributed.device_mesh.init_device_mesh``.

Backends (``init_ranks``): NCCL when every rank has a card of its own;
gloo when ranks share a card (NCCL refuses two ranks on one device), with
every rank on ``cuda:0`` and the collectives staged through host memory by
``distributed/collectives.py``; gloo on the CPU. The rendezvous is a
``FileStore``: no port, no network.

``spawn(fn, world_size, *args)`` runs ``fn(rank, *args)`` in
``world_size`` fresh processes with the process group up, and returns each
rank's result; any rank's failure raises in the caller after every rank
has stopped.
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = ["Mesh", "init_ranks", "make_local_mesh", "parse_mesh", "spawn"]

_POLL_S = 2.0  # spawn: seconds between looks at the ranks' exit codes


class Mesh:
    """A (data, model) mesh of ranks."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.device = device
        self.backend = backend
        coord = device_mesh.get_coordinate()
        self._index = dict(zip(self.axis_names, coord))

    def index(self, axis: str) -> int:
        """The calling rank's coordinate on ``axis``."""
        return self._index[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device}, index={self._index})")


def _backend_and_device(world_size: int, rank: int, device=None):
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() >= world_size:
            return "nccl", torch.device("cuda", rank)
        return "gloo", torch.device("cuda", 0)
    return "gloo", torch.device("cpu")


def init_ranks(rank: int, world_size: int, store_path: str, *,
               device=None) -> torch.device:
    """Join the process group (``FileStore`` at ``store_path``) with the
    backend the devices allow; returns the rank's device."""
    backend, dev = _backend_and_device(world_size, rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    return dev


def make_local_mesh(n_data: int = 1, n_model: int = 1, *, device=None) -> Mesh:
    """The (n_data, n_model) mesh over the ranks of the process group
    (``init_ranks``), which must number n_data x n_model; a rank's device
    defaults to the card, as every entry point's does."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs the process group "
                           "(launch.mesh.init_ranks or spawn)")
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} "
                         f"ranks, the process group has {world}")
    backend = dist.get_backend()
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    # a gloo mesh moves host tensors (collectives.py stages CUDA ones)
    mesh_dev = "cuda" if backend == "nccl" else "cpu"
    dm = init_device_mesh(mesh_dev, (n_data, n_model),
                          mesh_dim_names=("data", "model"))
    return Mesh(dm, dev, backend)


def parse_mesh(spec: Optional[str], *, device=None) -> Optional[Mesh]:
    """A ``--mesh`` flag as a (data, model) mesh, or None.

    "1" / "" / None: one device, no mesh; "4": data=4, model=1; "2x4":
    data=2, model=4. The product must equal the process group's size.
    """
    if not spec or spec == "1":
        return None
    parts = spec.lower().split("x")
    if len(parts) == 1:
        n_data, n_model = int(parts[0]), 1
    elif len(parts) == 2:
        n_data, n_model = int(parts[0]), int(parts[1])
    else:
        raise ValueError(f"bad mesh spec {spec!r}; expected 'D' or 'DxM'")
    if n_data * n_model == 1:
        return None
    return make_local_mesh(n_data, n_model, device=device)


def _rank_main(rank, world_size, store_path, device, threads, fn, args,
               results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_ranks(rank, world_size, store_path, device=device)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, *args, device=None, timeout: float = 600.0,
          threads: int = 0) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned ranks with the
    process group up (``init_ranks``; ``device`` as there); returns the
    results by rank. ``fn`` and its results must pickle. Raises
    ``RuntimeError`` with the failing ranks' tracebacks, when a rank ends
    without a result (its exit code), or on timeout, after every rank has
    stopped. ``threads`` > 0 caps each rank's intra-op threads."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, store, device, threads, fn,
                                   args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size and not errors:
                try:
                    rank, ok, out = results.get(timeout=_POLL_S)
                except queue.Empty:
                    waiting = sorted(set(range(world_size)) - set(got))
                    # a rank that ended without a result (killed, crashed,
                    # failed to start) ends the wait; one that returned
                    # exits 0 after its result is queued
                    dead = [(r, procs[r].exitcode) for r in waiting
                            if procs[r].exitcode not in (None, 0)]
                    if dead:
                        errors.extend(f"rank {r} exited with code {c} "
                                      "without a result" for r, c in dead)
                    elif time.monotonic() > deadline:
                        errors.append(f"timed out after {timeout} s waiting "
                                      f"for ranks {waiting}")
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
        finally:
            for p in procs:
                p.join(timeout=5 if errors else 60)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world_size)]
