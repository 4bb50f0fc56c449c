"""Checkpoints: one ``.npy`` per leaf plus a JSON manifest, written atomically.

Port of ``repro/checkpoint/ckpt.py`` (DESIGN.md §2), synchronous:
  * atomic: the leaves and the manifest go to ``<dir>/step_N.tmp``, the
    manifest is fsynced, then the directory is renamed to ``<dir>/step_N``;
    a crash mid-write never corrupts the latest checkpoint;
  * restartable: ``latest_step`` / ``restore`` pick up the newest complete
    checkpoint; the data stream's state is the step counter, so a restart
    resumes bit-identically.

A tree is a nested dict / list / NamedTuple of tensors and Python ints
(parameters, ``AdamWState``). bf16 tensors are stored as their int16 bits
with the dtype named in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_paths, tree_unflatten


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


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
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


def restore(ckpt_dir: str, step: int, like: Any):
    """Restore a tree saved with ``save``. ``like`` supplies the structure;
    each tensor comes back on its ``like`` leaf's device and dtype (a
    mismatch in shape or dtype raises)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = {m["name"]: m for m in json.load(f)["leaves"]}
    leaves = []
    for name, ref in _named_leaves(like):
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
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(
                f"{name}: checkpoint holds {t.dtype} {tuple(t.shape)}, "
                f"expected {ref.dtype} {tuple(ref.shape)}")
        leaves.append(t.to(ref.device))
    return tree_unflatten(like, leaves)
