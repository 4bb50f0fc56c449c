"""Checkpoints: one ``.npy`` per leaf plus a JSON manifest, written atomically.

Port of ``repro/checkpoint/ckpt.py`` (DESIGN.md §2) for one device:
  * atomic: the leaves and the manifest (with the caller's ``extra``
    metadata) go to ``<dir>/step_N.tmp``, the manifest is fsynced, then the
    directory is renamed to ``<dir>/step_N``; a crash mid-write never
    corrupts the latest checkpoint;
  * restartable: ``latest_step`` / ``restore`` pick up the newest complete
    checkpoint; the data stream's state is the step counter, so a restart
    resumes bit-identically;
  * async: ``AsyncCheckpointer`` copies the tree to the host, then writes it
    in a background thread while training goes on;
  * elastic: under a mesh (``mesh`` and a placement tree, as
    ``train()`` passes them) every rank gathers its blocks into whole
    tensors and rank 0 of the process group writes them, so a checkpoint
    is the same whatever the mesh; ``restore`` cuts each whole tensor to
    the restoring rank's block, so a relaunch on another mesh re-shards it.

A tree is a nested dict / list / NamedTuple of tensors and Python ints
(parameters, ``AdamWState``). bf16 tensors are stored as their int16 bits
with the dtype named in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_paths, tree_unflatten


def _named_leaves(tree):
    """(file name, leaf) pairs in ``tree_paths`` order."""
    return [("leaf_" + ".".join(path), leaf) for path, leaf in tree_paths(tree)]


def _to_numpy(leaf):
    """(array, dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, "int" if isinstance(leaf, int) else str(arr.dtype)


def _placed_leaves(tree, placements):
    """(leaf, pspec) pairs in ``tree_paths`` order."""
    pl = dict(tree_paths(placements))  # a pspec (plain tuple) is a leaf
    return [(leaf, pl[path]) for path, leaf in tree_paths(tree)]


def gather_tree(tree, mesh, placements):
    """Every rank's blocks of ``tree`` (placed by ``placements``) gathered
    into whole tensors, on every rank (a collective: all ranks call it)."""
    from repro_torch.distributed import collectives as C

    out = []
    for leaf, pspec in _placed_leaves(tree, placements):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            for dim, part in enumerate(pspec):
                for axis in ((part,) if isinstance(part, str) else
                             (part or ())):
                    t = C.all_gather(t, mesh, axis, dim)
            leaf = t
        out.append(leaf)
    return tree_unflatten(tree, out)


def _writer(mesh) -> bool:
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == 0


def _barrier(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def save(ckpt_dir: str, step: int, tree: Any, *,
         extra: Optional[dict] = None, mesh=None, placements=None) -> str:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>``; under ``mesh`` every
    rank calls it with its blocks and rank 0 writes the whole tensors."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    if mesh is not None:
        tree = gather_tree(tree, mesh, placements)
        if not _writer(mesh):
            _barrier(mesh)
            return final
    path = _write(ckpt_dir, step, tree, extra)
    _barrier(mesh)
    return path


def _write(ckpt_dir: str, step: int, tree: Any,
           extra: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, leaf in _named_leaves(tree):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, *, mesh=None,
            placements=None):
    """Restore a tree saved with ``save``. ``like`` supplies the structure;
    each tensor comes back on its ``like`` leaf's device and dtype (a
    mismatch in shape or dtype raises). Under ``mesh`` the like leaves are
    the rank's blocks, placed by ``placements``: each whole tensor is cut
    to the block, whatever mesh saved it."""
    from repro_torch.distributed.sharding import local_block

    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = {m["name"]: m for m in json.load(f)["leaves"]}
    pspecs = ([p for _, p in _placed_leaves(like, placements)]
              if mesh is not None else [None] * len(tree_leaves(like)))
    leaves = []
    for (name, ref), pspec in zip(_named_leaves(like), pspecs):
        if name not in manifest:
            raise ValueError(f"{path} has no leaf {name}")
        arr = np.load(os.path.join(path, name + ".npy"))
        dtype = manifest[name]["dtype"]
        if not isinstance(ref, torch.Tensor):
            leaves.append(int(arr) if dtype == "int" else arr)
            continue
        t = torch.from_numpy(arr)
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        if pspec is not None:
            t = local_block(t, pspec, mesh).contiguous()
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(
                f"{name}: checkpoint holds {t.dtype} {tuple(t.shape)}, "
                f"expected {ref.dtype} {tuple(ref.shape)}")
        leaves.append(t.to(ref.device))
    return tree_unflatten(like, leaves)


class AsyncCheckpointer:
    """Snapshot to the host, then write in a background thread.

    ``save`` returns once every tensor is copied to host memory: the port's
    AdamW updates parameters and moments in place, and a CPU tensor's
    ``.cpu()`` is the tensor itself, so the snapshot is always a copy.
    ``wait`` joins the writer; a second ``save`` waits for the first.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, ckpt_dir: str, step: int, tree: Any, *,
             extra: Optional[dict] = None, mesh=None, placements=None):
        """Snapshot ``tree`` (under ``mesh``: gathered whole, a collective)
        and write it in the background (under ``mesh``: rank 0 only)."""
        self.wait()
        if mesh is not None:
            tree = gather_tree(tree, mesh, placements)
        host = tree_unflatten(tree, [
            leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else leaf
            for leaf in tree_leaves(tree)])
        if not _writer(mesh):
            self.last_path = os.path.join(ckpt_dir, f"step_{step}")
            return

        def _write_host():
            self.last_path = _write(ckpt_dir, step, host, extra)

        self._thread = threading.Thread(target=_write_host, daemon=False)
        self._thread.start()
