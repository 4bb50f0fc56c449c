"""Parameters of the ported families: random init and conversion from JAX.

Port of ``repro/models/params.py`` for the ported families (dense, MoE,
hubert, internvl, and rwkv6 and recurrentgemma, whose trees
``models/rwkv6.py`` and ``models/recurrentgemma.py`` declare).
Parameters are a plain nested dict of tensors with the
reference's names and layouts (``embed.tok`` (V, d), ``layers[i].attn.wq``
(d, H, hd), an MoE layer's ``layers[i].moe.wi`` (E, d, f) in place of
``mlp``, a gelu MLP's biases ``bi`` / ``bo``, a layernorm's ``b``, learned
positions ``embed.pos`` (max_seq, d), a frontend's ``frontend.proj``
(frontend_dim, d) and hubert's ``frontend.mask_embed`` (d,)); the layers
are always a per-layer list here, whatever ``cfg.scan_layers`` says about
the reference's stacked layout (``params_from_jax`` unstacks it).

Dtype semantics follow the reference: every tensor is stored at its
declared dtype (``cfg.param_dtype`` for weights, fp32 for the norm weights
and biases of ``ln1/ln2/ln_f``), and the layers cast to the activation
dtype at use.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import FAMILIES, ModelConfig


class TensorSpec(NamedTuple):
    """A declared tensor: shape, dtype, initializer and logical axes.

    init: "normal" (truncated normal, std ``scale`` or 1/sqrt(fan-in)) |
    "embed" (normal, std ``scale`` or 0.02) | "zeros" | "ones" | "fill"
    (the constant ``fill``). axes: one logical axis name (or None) per
    dimension, the reference's ``ParamSpec.axes``, which
    ``distributed/sharding.py`` resolves against a mesh; None = all
    replicated.
    """

    shape: tuple
    dtype: torch.dtype
    init: str = "normal"
    fill: float = 0.0
    scale: Optional[float] = None
    axes: Optional[tuple] = None


def _spec(shape, dtype, init="normal", axes=None):
    return TensorSpec(tuple(shape), dtype, init,
                      axes=None if axes is None else tuple(axes))


def spec_paths(tree, path=()):
    """(path, TensorSpec) pairs of a nested dict / list spec tree, in
    ``tree_paths`` order (a TensorSpec is a leaf here)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_paths(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from spec_paths(v, path + (str(i),))
    else:
        yield path, tree


def map_specs(tree, fn):
    """``fn`` on every TensorSpec of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: map_specs(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(v, fn) for v in tree]
    return fn(tree)


def fill_value(spec: TensorSpec) -> float:
    """The constant a ``zeros`` / ``ones`` / ``fill`` spec initializes to
    (a state cache's slot reset rewrites its rows with it, so a reset
    equals a fresh init bit for bit)."""
    value = {"zeros": 0.0, "ones": 1.0, "fill": spec.fill}.get(spec.init)
    if value is None:
        raise ValueError(f"init {spec.init!r} is random: it has no constant "
                         "(use init_params)")
    return value


def materialize(spec: TensorSpec, device) -> torch.Tensor:
    """A constant-initialized tensor (zeros / ones / fill) for ``spec``."""
    return torch.full(spec.shape, fill_value(spec), dtype=spec.dtype,
                      device=device)


def norm_specs(cfg: ModelConfig) -> dict:
    d, f32, ax = cfg.d_model, torch.float32, ("d_model",)
    if cfg.norm == "layernorm":
        return {"w": _spec((d,), f32, "ones", ax),
                "b": _spec((d,), f32, "zeros", ax)}
    return {"w": _spec((d,), f32, "ones", ax)}


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f, pdt = cfg.d_model, cfg.d_ff, cfg.pdt
    di, do = ("d_model", "d_ff"), ("d_ff", "d_model")
    if cfg.act == "swiglu":
        return {"wi": _spec((d, f), pdt, axes=di),
                "wg": _spec((d, f), pdt, axes=di),
                "wo": _spec((f, d), pdt, axes=do)}
    return {"wi": _spec((d, f), pdt, axes=di),
            "bi": _spec((f,), pdt, "zeros", ("d_ff",)),
            "wo": _spec((f, d), pdt, axes=do),
            "bo": _spec((d,), pdt, "zeros", ("d_model",))}


def attn_specs(cfg: ModelConfig) -> dict:
    """The GQA projections (with the optional qkv biases and qk norms)."""
    d, H, Hkv, hd = cfg.d_model, cfg.padded_heads, cfg.kv_heads, cfg.hd
    pdt = cfg.pdt
    q_ax, kv_ax = ("d_model", "heads", None), ("d_model", "kv_heads", None)
    attn = {"wq": _spec((d, H, hd), pdt, axes=q_ax),
            "wk": _spec((d, Hkv, hd), pdt, axes=kv_ax),
            "wv": _spec((d, Hkv, hd), pdt, axes=kv_ax),
            "wo": _spec((H, hd, d), pdt, axes=("heads", None, "d_model"))}
    if cfg.qkv_bias:
        attn["bq"] = _spec((H, hd), pdt, "zeros", ("heads", None))
        attn["bk"] = _spec((Hkv, hd), pdt, "zeros", ("kv_heads", None))
        attn["bv"] = _spec((Hkv, hd), pdt, "zeros", ("kv_heads", None))
    if cfg.qk_norm:
        attn["qnorm"] = _spec((hd,), pdt, "ones", (None,))
        attn["knorm"] = _spec((hd,), pdt, "ones", (None,))
    return attn


def _layer_specs(cfg: ModelConfig) -> dict:
    layer = {"ln1": norm_specs(cfg), "attn": attn_specs(cfg),
             "ln2": norm_specs(cfg)}
    if cfg.family == "moe" and cfg.moe is not None:
        from .moe import moe_specs

        layer["moe"] = moe_specs(cfg)
    else:
        layer["mlp"] = mlp_specs(cfg)
    return layer


def embed_specs(cfg: ModelConfig) -> dict:
    """The token table, the learned positions under ``pos="learned"`` and
    the LM head unless tied."""
    d, pdt = cfg.d_model, cfg.pdt
    embed = {"tok": _spec((cfg.padded_vocab, d), pdt, "embed",
                          ("vocab", "d_model"))}
    if cfg.pos == "learned":
        embed["pos"] = _spec((cfg.max_seq, d), pdt, "embed",
                             (None, "d_model"))
    if not cfg.tie_embeddings:
        embed["head"] = _spec((d, cfg.padded_vocab), pdt,
                              axes=("d_model", "vocab"))
    return embed


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as (shape, dtype, init) leaves."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the port "
                         f"has {FAMILIES}")
    if cfg.family == "rwkv6":
        from .rwkv6 import param_specs as rwkv6_specs

        return rwkv6_specs(cfg)
    if cfg.family == "recurrentgemma":
        from .recurrentgemma import param_specs as rgemma_specs

        return rgemma_specs(cfg)
    d, pdt = cfg.d_model, cfg.pdt
    p = {"embed": embed_specs(cfg), "ln_f": norm_specs(cfg),
         "layers": [_layer_specs(cfg) for _ in range(cfg.num_layers)]}
    if cfg.frontend == "audio_frames":
        p["frontend"] = {"proj": _spec((cfg.frontend_dim, d), pdt,
                                       axes=(None, "d_model")),
                         "mask_embed": _spec((d,), pdt, "embed",
                                             ("d_model",))}
    if cfg.frontend == "vision_patches":
        p["frontend"] = {"proj": _spec((cfg.frontend_dim, d), pdt,
                                       axes=(None, "d_model"))}
    return p


def _init_one(spec: TensorSpec, gen: torch.Generator, device) -> torch.Tensor:
    shape, dtype, init = spec.shape, spec.dtype, spec.init
    if init not in ("normal", "embed"):
        return materialize(spec, device)
    # drawn in fp32 and scaled in place (one fp32 transient a leaf: kimi-k2's
    # 384 x 7168 x 2048 expert leaf is 22.5 GB of it)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if init == "embed":
        std = spec.scale if spec.scale is not None else 0.02
        return x.normal_(generator=gen).mul_(std).to(dtype)
    # truncated-normal init at std ``scale``, else fan-in (fan-in = the
    # second-to-last axis, as in the reference's init_one)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(std).to(dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_paths(tree, path=()):
    """(path, leaf) pairs of a nested dict / list / NamedTuple tree, in
    ``jax.tree`` order (dict keys sorted); a path is a tuple of str."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from tree_paths(getattr(tree, k), path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (str(i),))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """Leaves of a tree in ``tree_paths`` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` (``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, k)) for k in t._fields))
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(like)


def init_params(cfg: ModelConfig, seed: int = 0, device=None, *,
                mesh=None) -> dict:
    """Random parameters from ``seed``, made on ``device`` (default: cuda).

    One ``torch.Generator`` on the target device draws every leaf in tree
    order, so a seed gives the same weights on every run on that device
    (not the reference's bits: the tests carry JAX weights over with
    ``params_from_jax`` instead). Every leaf is a leaf tensor that takes
    ``requires_grad_()`` for training. With ``mesh``, each leaf is drawn
    whole and cut to the calling rank's block before the next is drawn:
    the blocks of the one-device tree.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if mesh is None:
        return _map(param_specs(cfg), lambda s: _init_one(s, gen, dev))
    from repro_torch.distributed.sharding import local_block, logical_to_pspec

    def one(s):
        pspec = logical_to_pspec(s.shape, s.axes or (None,) * len(s.shape),
                                 mesh)
        return local_block(_init_one(s, gen, dev), pspec, mesh).clone()

    return _map(param_specs(cfg), one)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves, e.g. from
    ``jax.device_get``) as the port's, on ``device`` (default: cuda).

    Takes every reference layout of the layers: the per-layer list, the
    stacked ``(L, ...)`` arrays of ``scan_layers=True`` configs, and
    recurrentgemma's ``groups`` (one stacked ``(n_groups, ...)`` tree per
    position of the block pattern) and unstacked ``tail``, unstacked in the
    reference's ``_layers_iter`` order: group 0's pattern, group 1's, ...,
    then the tail.
    """
    dev = resolve_device(device)
    if "groups" in tree:
        if not cfg.scan_layers:
            raise ValueError(f"config {cfg.name} has scan_layers=False but "
                             "the tree holds stacked groups")
        groups = list(tree["groups"])
        n_groups = len(np.asarray(tree_leaves(groups[0])[0]))
        layers = [_map(grp, lambda a, i=i: np.asarray(a)[i])
                  for i in range(n_groups) for grp in groups]
        layers += list(tree["tail"])
    else:
        layers = tree["layers"]
        if isinstance(layers, dict) != cfg.scan_layers:
            raise ValueError(
                f"config {cfg.name} has scan_layers={cfg.scan_layers} but the "
                f"tree's layers are a {type(layers).__name__}")
        if cfg.scan_layers:  # stacked (L, ...) leaves
            layers = [_map(layers, lambda a, i=i: np.asarray(a)[i])
                      for i in range(cfg.num_layers)]
    if len(layers) != cfg.num_layers:
        raise ValueError(
            f"reference tree has {len(layers)} layers, config {cfg.num_layers}")
    specs = param_specs(cfg)
    out = _map({**{k: tree[k] for k in specs if k != "layers"},
                "layers": list(layers)}, lambda a: _to_tensor(a, dev))

    def check(spec_tree, got, path):
        if isinstance(spec_tree, dict):
            if set(spec_tree) != set(got):
                raise ValueError(f"{path}: keys {sorted(got)} != "
                                 f"{sorted(spec_tree)}")
            for k in spec_tree:
                check(spec_tree[k], got[k], f"{path}.{k}")
        elif isinstance(spec_tree, list):
            for i, (s, g) in enumerate(zip(spec_tree, got)):
                check(s, g, f"{path}[{i}]")
        elif tuple(got.shape) != spec_tree.shape:
            raise ValueError(f"{path}: shape {tuple(got.shape)} != "
                             f"{spec_tree.shape}")

    check(specs, out, "params")
    return out
