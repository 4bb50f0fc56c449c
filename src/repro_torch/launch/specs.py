"""Abstract inputs for the dry run: meta tensors of one rank's local shapes.

Port of ``repro/launch/specs.py``. The reference builds
``jax.ShapeDtypeStruct``s carrying a ``NamedSharding`` of the global shape;
here each input is a tensor on the meta device (no storage) holding rank
0's block, placed by the port's own rules: the parameters by
``distributed/sharding.param_placements``, the batch rows over the data
axes where they divide (``logical_to_pspec``), the serving cache by ``place_specs`` (batch
over data, kv-heads over "model", the sequence whole). The mesh is a
``launch.mesh.AbstractMesh`` (or any mesh with ``shape``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.distributed.sharding import (
    ShardingRules,
    local_shape,
    logical_to_pspec,
)
from repro_torch.models.params import map_specs, param_specs
from repro_torch.models.registry import get_model
from repro_torch.serve.cache.protocol import place_specs

META = torch.device("meta")

__all__ = ["batch_specs", "cache_abstract", "decode_tokens_abstract",
           "params_abstract", "tree_bytes"]


def _meta(shape, dtype, mesh):
    """A (batch, ...) input: its rows over the data axes where they divide
    (a batch of one slot stays whole on every rank)."""
    if mesh is not None:
        pspec = logical_to_pspec(shape, ("batch",) + (None,) * (len(shape) - 1),
                                 mesh)
        shape = local_shape(shape, pspec, mesh)
    return torch.empty(shape, dtype=dtype, device=META)


def params_abstract(cfg: ModelConfig, mesh,
                    rules: Optional[ShardingRules] = None) -> dict:
    """The parameter tree of rank 0's blocks (``init_params(..., mesh=)``'s
    shapes and dtypes), on the meta device."""
    def one(s):
        if mesh is None:
            return torch.empty(s.shape, dtype=s.dtype, device=META)
        pspec = logical_to_pspec(s.shape, s.axes or (None,) * len(s.shape),
                                 mesh, rules)
        return torch.empty(local_shape(s.shape, pspec, mesh), dtype=s.dtype,
                           device=META)

    return map_specs(param_specs(cfg), one)


def batch_specs(cfg: ModelConfig, shape: ShapeCfg, mesh) -> dict:
    """Rank 0's rows of a training / prefill batch (``make_batch``'s keys):
    tokens and targets; hubert's frames, mask positions and targets;
    internvl's text tokens, patches and targets."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if cfg.family == "hubert":
        return {"frames": _meta((B, S, cfg.frontend_dim), f32, mesh),
                "mask_positions": _meta((B, S), torch.bool, mesh),
                "targets": _meta((B, S), i32, mesh)}
    if cfg.family == "internvl":
        P = cfg.num_patches
        return {"tokens": _meta((B, S - P), i32, mesh),
                "patches": _meta((B, P, cfg.frontend_dim), f32, mesh),
                "targets": _meta((B, S - P), i32, mesh)}
    return {"tokens": _meta((B, S), i32, mesh),
            "targets": _meta((B, S), i32, mesh)}


def cache_abstract(cfg: ModelConfig, shape: ShapeCfg, mesh) -> dict:
    """Rank 0's serving cache of ``shape.global_batch`` slots of
    ``shape.seq_len`` positions (the family's ``cache_specs``, placed as
    the engine places it)."""
    specs = get_model(cfg).cache_specs(cfg, shape.global_batch,
                                       shape.seq_len)
    if mesh is not None:
        specs = place_specs(specs, mesh)
    return map_specs(specs, lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                  device=META))


def decode_tokens_abstract(cfg: ModelConfig, shape: ShapeCfg, mesh):
    """Rank 0's decode tokens: one a slot."""
    return _meta((shape.global_batch,), torch.int32, mesh)


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a (nested dict / list) tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
