"""Logical-axis -> mesh-axis sharding rules with divisibility fallback.

Port of ``repro/distributed/sharding.py``. Every parameter and cache
tensor declares *logical* axis names (``TensorSpec.axes``: "batch",
"heads", "d_ff", "experts", ...). This module resolves them against a mesh,
taking the most parallel mapping that divides the dimension: qwen2's 28
heads do not divide a 16-way model axis, so its heads stay replicated while
its d_ff = 18944 = 16 x 1184 still shards (DESIGN.md §4).

Rules are an ordered list of candidate mesh-axis groups per logical axis.
A group is taken iff (a) every mesh axis in it exists, (b) none is already
used by another dimension of the same tensor, and (c) the dimension is
divisible by the group's total size. A placement ("pspec") is a tuple with
one entry per dimension: None (replicated), an axis name, or a tuple of
axis names.

``param_placements`` is the placement of a config's parameter tree;
``shard_params`` cuts a full tree (``init_params``, ``params_from_jax``) to
the calling rank's blocks, and ``local_block`` cuts one tensor.

Attention needs no wrapper of its own (the reference's ``shard_attn.py``
cuts each shard's block out of global arrays with ``shard_map``). MRA-2 is
independent over (batch, kv-head), and each rank already holds its block:
the tensor-parallel projections (``models/layers.py``) make the rank's
q / k / v heads from its weight blocks, and the batch and the decode state
are placed by the same rule (batch -> the data axes, kv-heads -> "model",
q's group-major heads in the matching contiguous chunks). So attention
runs the rank's ordinary single-device code (the kernel wrapper on a
card, its plain twin on the CPU) on its blocks, with no collective in the
forward. ``attention_partition`` / ``attention_pspec`` state that
placement for whatever cuts attention operands out of whole tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.models.params import (
    map_specs,
    param_specs,
    spec_paths,
    tree_paths,
    tree_unflatten,
)

__all__ = ["DEFAULT_RULES", "ShardingRules", "attention_partition",
           "attention_pspec", "batch_pspec", "local_block", "local_shape", "logical_to_pspec", "param_placements",
           "shard_params", "shard_tree"]

# candidate mesh-axis groups in preference order, per logical axis
DEFAULT_RULES: dict = {
    "batch": (("pod", "data"), ("data",)),
    "seq": (("model",),),          # sequence parallelism (MoE a2a dispatch)
    "kv_seq": (("data",),),        # long-context KV-cache sequence sharding
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "d_ff": (("model",),),
    "experts": (("model",),),
    "expert_ff": (("model",),),    # fallback TP inside experts
    "d_model": (),                 # replicated (activations stay batch-sharded)
    "zero": (("pod", "data"), ("data",)),  # ZeRO-1 optimizer-state sharding
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))

    def override(self, **kw) -> "ShardingRules":
        new = dict(self.rules)
        new.update(kw)
        return ShardingRules(new)


def _axis_size(mesh, names: Sequence[str]) -> int:
    return math.prod(mesh.shape[n] for n in names)


def logical_to_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                     mesh, rules: Optional[ShardingRules] = None) -> tuple:
    """Resolve logical axes to a placement for ``mesh`` (reads only
    ``mesh.shape``, a mapping of axis name to size)."""
    rules = rules or ShardingRules()
    used: set = set()
    parts = []
    for dim, name in zip(shape, axes):
        chosen = None
        for group in rules.rules.get(name, ()) if name else ():
            if not all(a in mesh.shape for a in group):
                continue
            if any(a in used for a in group):
                continue
            if dim % _axis_size(mesh, group) != 0:
                continue
            chosen = group
            break
        if chosen is None:
            parts.append(None)
        else:
            used.update(chosen)
            parts.append(chosen if len(chosen) > 1 else chosen[0])
    return tuple(parts)


def batch_pspec(mesh, ndim: int = 2,
                rules: Optional[ShardingRules] = None) -> tuple:
    """Placement of a (batch, ...) activation: batch over the data axes."""
    lead = logical_to_pspec((1 << 30,), ("batch",), mesh, rules)  # divisible
    return (lead[0],) + (None,) * (ndim - 1)


def attention_partition(mesh, batch: int, kv_heads: int):
    """(batch part, head part) of attention operands with ``batch`` rows
    and ``kv_heads`` kv heads, or None if neither splits: the batch over
    the widest group of data axes that divides it, the kv heads over
    "model" when they divide it (GQA stays aligned)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    while dp and batch % _axis_size(mesh, dp) != 0:
        dp = dp[1:]
    m = mesh.shape.get("model", 1)
    hax = "model" if m > 1 and kv_heads % m == 0 else None
    if not dp and hax is None:
        return None
    return (None if not dp else (dp if len(dp) > 1 else dp[0])), hax


def attention_pspec(parts, ndim: int, *, heads: bool = True) -> tuple:
    """The placement of a (batch, kv-head, ...) operand (``heads=False``:
    a (batch, ...) one) under ``parts`` (``attention_partition``)."""
    bpart, hpart = parts if parts is not None else (None, None)
    if heads:
        return (bpart, hpart) + (None,) * (ndim - 2)
    return (bpart,) + (None,) * (ndim - 1)


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _coord(mesh, part) -> Tuple[int, int]:
    """(index, count) of the calling rank along a placement entry."""
    idx, n = 0, 1
    for a in _axes_of(part):
        idx = idx * mesh.shape[a] + mesh.index(a)
        n *= mesh.shape[a]
    return idx, n


def local_shape(shape: Sequence[int], pspec: tuple, mesh) -> tuple:
    """The shape of one rank's block of a tensor placed by ``pspec``."""
    return tuple(d // _axis_size(mesh, _axes_of(p)) for d, p in
                 zip(shape, pspec))


def local_block(t, pspec: tuple, mesh):
    """The calling rank's block of the full tensor ``t`` (a view)."""
    for dim, part in enumerate(pspec):
        idx, n = _coord(mesh, part)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def _pspec(spec, mesh, rules) -> tuple:
    return logical_to_pspec(spec.shape, spec.axes or (None,) * len(spec.shape),
                            mesh, rules)


def param_placements(cfg, mesh, rules: Optional[ShardingRules] = None):
    """The placement of ``cfg``'s parameter tree on ``mesh``: a tree of
    pspecs shaped like ``param_specs(cfg)``."""
    return map_specs(param_specs(cfg), lambda s: _pspec(s, mesh, rules))


def shard_tree(tree, spec_tree, mesh, rules: Optional[ShardingRules] = None):
    """Each tensor of ``tree`` (full, or already this rank's block) as the
    calling rank's block, contiguous. Raises on a shape that is neither."""
    specs = dict(spec_paths(spec_tree))
    out = []
    for path, leaf in tree_paths(tree):
        spec = specs[path]
        pspec = _pspec(spec, mesh, rules)
        local = local_shape(spec.shape, pspec, mesh)
        if tuple(leaf.shape) == tuple(spec.shape):
            out.append(local_block(leaf, pspec, mesh).contiguous())
        elif tuple(leaf.shape) == local:
            out.append(leaf)
        else:
            raise ValueError(f"{'.'.join(path)}: shape {tuple(leaf.shape)} is "
                             f"neither the full {spec.shape} nor the block "
                             f"{local}")
    return tree_unflatten(tree, out)


def shard_params(params, cfg, mesh, rules: Optional[ShardingRules] = None):
    """A full parameter tree (``init_params``, ``params_from_jax``) cut to
    the calling rank's blocks on ``mesh``; blocks pass through."""
    return shard_tree(params, param_specs(cfg), mesh, rules)
