"""Model weights drawn from the seed, in the parameter layout that
``repro_torch`` serves and trains from.

The layout is the port's plain nested dict (``repro_torch/models/params.py``):
``embed.tok`` (Vp, d), ``embed.head`` (d, Vp) unless tied, ``ln_f.w`` (d,),
and per layer ``ln1.w`` / ``ln2.w`` (d,), ``attn.wq`` (d, H, hd),
``attn.wk`` / ``attn.wv`` (d, Hkv, hd), ``attn.wo`` (H, hd, d),
``attn.qnorm`` / ``attn.knorm`` (hd,) under qk-norm, and either
``mlp.wi`` / ``mlp.wg`` (d, f), ``mlp.wo`` (f, d) or ``moe.router``
(d, E), ``moe.wi`` / ``moe.wg`` (E, d, f), ``moe.wo`` (E, f, d). Vp is the
vocab padded to a multiple of ``pad_vocab_to``.

Each kind of leaf is one tensor stacked over the layers, drawn on the
device by one ``normal_`` call of its own generator (seeded from the run's
seed and the group's index), so the weights take a dozen large calls and
any one group can be drawn again alone. A layer's leaf is a view of its
group. Matrices are N(0, 1/fan-in) clipped at two standard deviations
(fan-in: every axis the product contracts), the token table N(0, 0.02²),
norm gains 1.
"""
from __future__ import annotations

import math

import torch

_MIX = 0x9E3779B97F4A7C15


def group_seed(seed: int, index: int) -> int:
    """A generator seed for group ``index`` of a run's ``seed``."""
    return (int(seed) * 1_000_003 + (index + 1) * _MIX) % (1 << 63)


def padded_vocab(model: dict) -> int:
    m = max(int(model.get("pad_vocab_to", 256)), 1)
    return -(-int(model["vocab"]) // m) * m


def head_dim(model: dict) -> int:
    return int(model.get("head_dim") or model["d_model"] // model["num_heads"])


def groups(model: dict) -> list:
    """(path, shape, fan_in or None for ones / "embed") per group, in draw
    order; a path's ``*`` stands for the layer index, and such a group's
    shape has the layer count first."""
    d, H, Hkv = model["d_model"], model["num_heads"], model["kv_heads"]
    hd, L, Vp = head_dim(model), model["num_layers"], padded_vocab(model)
    out = [("embed.tok", (Vp, d), "embed")]
    if not model.get("tie_embeddings", False):
        out.append(("embed.head", (d, Vp), d))
    out.append(("ln_f.w", (d,), None))
    out += [("layers.*.ln1.w", (L, d), None), ("layers.*.ln2.w", (L, d), None),
            ("layers.*.attn.wq", (L, d, H, hd), d),
            ("layers.*.attn.wk", (L, d, Hkv, hd), d),
            ("layers.*.attn.wv", (L, d, Hkv, hd), d),
            ("layers.*.attn.wo", (L, H, hd, d), H * hd)]
    if model.get("qk_norm", False):
        out += [("layers.*.attn.qnorm", (L, hd), None),
                ("layers.*.attn.knorm", (L, hd), None)]
    moe = model.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        out += [("layers.*.moe.router", (L, d, E), d),
                ("layers.*.moe.wi", (L, E, d, f), d),
                ("layers.*.moe.wg", (L, E, d, f), d),
                ("layers.*.moe.wo", (L, E, f, d), f)]
    else:
        f = model["d_ff"]
        out += [("layers.*.mlp.wi", (L, d, f), d),
                ("layers.*.mlp.wg", (L, d, f), d),
                ("layers.*.mlp.wo", (L, f, d), f)]
    return out


def _fill(model: dict, seed: int, index: int, x: torch.Tensor):
    """Write group ``index``'s weights for ``seed`` into ``x`` in place."""
    _, _, fan = groups(model)[index]
    if fan is None:
        return x.fill_(1.0)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(group_seed(seed, index))
    x.normal_(generator=gen)
    if fan == "embed":
        return x.mul_(0.02)
    return x.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(fan))


def draw_group(model: dict, seed: int, index: int, device) -> torch.Tensor:
    """Group ``index`` of ``groups(model)`` as drawn for ``seed`` (fp32)."""
    _, shape, _ = groups(model)[index]
    return _fill(model, seed, index,
                 torch.empty(shape, dtype=torch.float32, device=device))


def _put(tree: dict, path: list, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def unstack(model: dict, stacks: list) -> dict:
    """The nested parameter dict whose leaves are views of ``stacks`` (one
    tensor per group, in ``groups`` order)."""
    L = model["num_layers"]
    tree = {"layers": [{} for _ in range(L)]}
    for (path, _, _), t in zip(groups(model), stacks):
        parts = path.split(".")
        if parts[0] == "layers":
            for i in range(L):
                _put(tree["layers"][i], parts[2:], t[i])
        else:
            _put(tree, parts, t)
    return tree


def make(model: dict, seed: int, device) -> tuple:
    """(params tree, the stacked groups it views) for ``seed``."""
    stacks = [draw_group(model, seed, i, device)
              for i in range(len(groups(model)))]
    return unstack(model, stacks), stacks


@torch.no_grad()
def redraw(model: dict, seed: int, stacks: list) -> None:
    """Write ``seed``'s weights into ``stacks`` again, in place: the same
    bits as ``make``, in the same tensors."""
    for i, t in enumerate(stacks):
        _fill(model, seed, i, t)


def leaf_paths(tree, path=()):
    """(dotted path, leaf) pairs in sorted-key order (the port's
    ``tree_leaves`` order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (str(i),))
    else:
        yield ".".join(path), tree


@torch.no_grad()
def change_norms(model: dict, seed: int, stacks: list) -> tuple:
    """(norms, paths): |p - p0| of every leaf as one tensor on the stacks'
    device, queued without a sync, and each entry's dotted path; p0 is
    drawn again from the seed one group at a time."""
    L = model["num_layers"]
    norms, paths = [], []
    for gi, (path, _, _) in enumerate(groups(model)):
        d = draw_group(model, seed, gi, stacks[gi].device).sub_(stacks[gi])
        layered = path.startswith("layers")
        norms.append(torch.linalg.vector_norm(
            d.reshape(L if layered else 1, -1), dim=1))
        paths += ([path.replace("*", str(i)) for i in range(L)] if layered
                  else [path])
        del d
    return torch.cat(norms), paths


def by_name(norms: torch.Tensor, paths: list, names: list) -> list:
    """The entries of ``change_norms``'s result in ``names``' order."""
    got = dict(zip(paths, norms.tolist()))
    return [got[n] for n in names]
