"""Parameters of the dense decoder: random init and conversion from JAX.

Port of ``repro/models/params.py`` for the dense family. Parameters are a
plain nested dict of tensors with the reference's names and layouts
(``embed.tok`` (V, d), ``layers[i].attn.wq`` (d, H, hd), ...); the layers
are always a per-layer list here, whatever ``cfg.scan_layers`` says about
the reference's stacked layout.

Dtype semantics follow the reference: every tensor is stored at its
declared dtype (``cfg.param_dtype`` for weights, fp32 for the norm weights
of ``ln1/ln2/ln_f``), and the layers cast to the activation dtype at use.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


class TensorSpec(NamedTuple):
    """A declared tensor: shape, dtype and initializer.

    init: "normal" (truncated-normal fan-in) | "embed" (normal, std 0.02) |
    "zeros" | "ones" | "fill" (the constant ``fill``).
    """

    shape: tuple
    dtype: torch.dtype
    init: str = "normal"
    fill: float = 0.0


def _spec(shape, dtype, init="normal"):
    return TensorSpec(tuple(shape), dtype, init)


def materialize(spec: TensorSpec, device) -> torch.Tensor:
    """A constant-initialized tensor (zeros / ones / fill) for ``spec``."""
    value = {"zeros": 0.0, "ones": 1.0, "fill": spec.fill}.get(spec.init)
    if value is None:
        raise ValueError(f"init {spec.init!r} is random; use init_params")
    return torch.full(spec.shape, value, dtype=spec.dtype, device=device)


def _layer_specs(cfg: ModelConfig) -> dict:
    d, H, Hkv, hd, f = (cfg.d_model, cfg.padded_heads, cfg.kv_heads, cfg.hd,
                        cfg.d_ff)
    if cfg.norm != "rmsnorm" or cfg.act != "swiglu":
        raise NotImplementedError(
            f"norm={cfg.norm!r} / act={cfg.act!r}: only the rmsnorm + swiglu "
            "dense decoder is ported")
    pdt, f32 = cfg.pdt, torch.float32
    attn = {"wq": _spec((d, H, hd), pdt), "wk": _spec((d, Hkv, hd), pdt),
            "wv": _spec((d, Hkv, hd), pdt), "wo": _spec((H, hd, d), pdt)}
    if cfg.qkv_bias:
        attn["bq"] = _spec((H, hd), pdt, "zeros")
        attn["bk"] = _spec((Hkv, hd), pdt, "zeros")
        attn["bv"] = _spec((Hkv, hd), pdt, "zeros")
    if cfg.qk_norm:
        attn["qnorm"] = _spec((hd,), pdt, "ones")
        attn["knorm"] = _spec((hd,), pdt, "ones")
    return {
        "ln1": {"w": _spec((d,), f32, "ones")},
        "attn": attn,
        "ln2": {"w": _spec((d,), f32, "ones")},
        "mlp": {"wi": _spec((d, f), pdt), "wg": _spec((d, f), pdt),
                "wo": _spec((f, d), pdt)},
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as (shape, dtype, init) leaves."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; only the dense decoder is")
    if cfg.pos != "rope":
        raise NotImplementedError(f"pos={cfg.pos!r}: only RoPE is ported")
    embed = {"tok": _spec((cfg.padded_vocab, cfg.d_model), cfg.pdt, "embed")}
    if not cfg.tie_embeddings:
        embed["head"] = _spec((cfg.d_model, cfg.padded_vocab), cfg.pdt)
    return {
        "embed": embed,
        "ln_f": {"w": _spec((cfg.d_model,), torch.float32, "ones")},
        "layers": [_layer_specs(cfg) for _ in range(cfg.num_layers)],
    }


def _init_one(spec: TensorSpec, gen: torch.Generator, device) -> torch.Tensor:
    shape, dtype, init = spec.shape, spec.dtype, spec.init
    if init not in ("normal", "embed"):
        return materialize(spec, device)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if init == "embed":
        return (x.normal_(generator=gen) * 0.02).to(dtype)
    # truncated-normal fan-in init (fan-in = second-to-last axis, as in the
    # reference's init_one)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * (1.0 / math.sqrt(fan_in))).to(dtype)


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


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, made on ``device`` (default: cuda).

    One ``torch.Generator`` on the target device draws every leaf in tree
    order, so a seed gives the same weights on every run on that device
    (not the reference's bits: the tests carry JAX weights over with
    ``params_from_jax`` instead). Every leaf is a leaf tensor that takes
    ``requires_grad_()`` for training.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _map(param_specs(cfg), lambda s: _init_one(s, gen, dev))


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves, e.g. from
    ``jax.device_get``) as the port's, on ``device`` (default: cuda).

    Takes both reference layouts of the layers: the per-layer list, and the
    stacked ``(L, ...)`` arrays of ``scan_layers=True`` configs.
    """
    dev = resolve_device(device)
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
    out = _map({"embed": tree["embed"], "ln_f": tree["ln_f"],
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
