"""AdamW with global-norm clipping, ZeRO-1 moments, and the cosine
learning-rate schedule.

Port of ``repro/optim/adamw.py``: the same order of operations as the
reference (fp32 moments, a global-norm clip, bias correction, and the
decoupled weight decay added to the update before the ``lr`` multiply), so
``torch.optim.AdamW``, whose order differs, is not used.

Under a mesh (``zero_plan``) the parameters are the rank's blocks and the
moments follow ``zero_pspec``: the parameter's own placement plus a data
split of its largest free divisible dimension (ZeRO-1). Each rank updates
its moment shard and that slice of its parameter block, then the slices
are all-gathered over the data axis. The global grad norm sums the squares
of every leaf split over "model" across that axis and counts each
replicated leaf once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models.params import tree_leaves, tree_unflatten


class AdamWState(NamedTuple):
    step: int  # updates applied so far
    mu: dict  # fp32 first moments, a tree like params
    nu: dict  # fp32 second moments


def zero_pspec(shape, mesh, rules: Optional[ShardingRules] = None, *,
               base=None) -> tuple:
    """ZeRO-1: shard the largest *free* divisible dim of optimizer state
    over the data axes, composed on top of the parameter's own placement
    ``base``."""
    rules = rules or ShardingRules()
    groups = rules.rules.get("zero", (("data",),))
    parts = (list(base) + [None] * (len(shape) - len(base))
             if base is not None else [None] * len(shape))
    used = set()
    for p in parts:
        if p is None:
            continue
        used.update(p if isinstance(p, tuple) else (p,))
    for group in groups:
        if not all(a in mesh.shape for a in group):
            continue
        if any(a in used for a in group):
            continue
        size = 1
        for a in group:
            size *= mesh.shape[a]
        dims = [i for i, d in enumerate(shape)
                if parts[i] is None and d % size == 0 and d >= size]
        if dims:
            dim = max(dims, key=lambda i: shape[i])
            parts[dim] = group if len(group) > 1 else group[0]
            break
    return tuple(parts)


def _axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


class ZeroPlan(NamedTuple):
    """Per leaf (``tree_leaves`` order) of a rank's parameter blocks: the
    dimension its moments split over "data" (None: whole) and whether the
    block is split over "model"."""

    mesh: object
    dims: list
    model_split: list


def zero_plan(params, placements, mesh,
              rules: Optional[ShardingRules] = None) -> ZeroPlan:
    """The ZeRO-1 plan of ``params`` (the rank's blocks) placed by
    ``placements`` (``param_placements``) on ``mesh``."""
    dims, split = [], []
    for p, ps in zip(tree_leaves(params), tree_leaves_pspec(placements)):
        full = tuple(n * math.prod(mesh.shape[a] for a in _axes(part))
                     for n, part in zip(p.shape, ps))
        zp = zero_pspec(full, mesh, rules, base=ps)
        dims.append(next((i for i, (a, b) in enumerate(zip(zp, ps))
                          if a != b), None))
        split.append(any("model" in _axes(part) for part in ps))
    return ZeroPlan(mesh, dims, split)


def tree_leaves_pspec(placements) -> list:
    """The pspecs of a placement tree in ``tree_leaves`` order (a pspec is
    a tuple, so it is a leaf here)."""
    if isinstance(placements, dict):
        return [x for k in sorted(placements)
                for x in tree_leaves_pspec(placements[k])]
    if isinstance(placements, list):
        return [x for v in placements for x in tree_leaves_pspec(v)]
    return [placements]


def _zero_slice(t, plan: ZeroPlan, i: int):
    dim = plan.dims[i]
    if dim is None:
        return t
    n = plan.mesh.shape["data"]
    size = t.shape[dim] // n
    return t.narrow(dim, plan.mesh.index("data") * size, size)


def global_norm(grads: list, plan: Optional[ZeroPlan] = None):
    """The fp32 global norm of gradient leaves, their squares summed leaf
    by leaf in tree order; under ``plan`` (the rank's blocks) the
    model-split leaves' squares are summed over "model" and each replicated
    leaf counts once."""
    sq = [torch.sum(g.to(torch.float32) ** 2) for g in grads]
    if plan is None:
        total = sq[0]
        for x in sq[1:]:
            total = total + x
        return torch.sqrt(total)
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    split = sum((x for x, m in zip(sq, plan.model_split) if m), zero)
    rep = sum((x for x, m in zip(sq, plan.model_split) if not m), zero)
    return torch.sqrt(C.all_reduce(split, plan.mesh, "model") + rep)


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params, plan: Optional[ZeroPlan] = None) -> AdamWState:
        """Zero moments: whole leaves, or under ``plan`` the rank's ZeRO-1
        shards."""
        leaves = tree_leaves(params)

        def zeros(i, p):
            shape = (p.shape if plan is None
                     else _zero_slice(p, plan, i).shape)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdamWState(
            0, tree_unflatten(params, [zeros(i, p) for i, p in enumerate(leaves)]),
            tree_unflatten(params, [zeros(i, p) for i, p in enumerate(leaves)]))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr,
               plan: Optional[ZeroPlan] = None):
        """One AdamW step; returns (params, state, gnorm).

        Updates the parameters and the moments **in place** (under
        ``torch.no_grad()``, so parameter leaves keep ``requires_grad``) and
        returns the same trees; the reference returns new arrays. Under
        ``plan`` the gradients are the rank's blocks, already averaged over
        the data axis, and the moments its ZeRO-1 shards.
        """
        gl = tree_leaves(grads)
        pl, ml, nl = (tree_leaves(t) for t in (params, state.mu, state.nu))
        gnorm = global_norm(gl, plan)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        t = torch.tensor(float(step), dtype=torch.float32, device=gnorm.device)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                          device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                          device=t.device), t)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        for i, (p, g, mu, nu) in enumerate(zip(pl, gl, ml, nl)):
            ps = p if plan is None else _zero_slice(p, plan, i)
            g = (g if plan is None else _zero_slice(g, plan, i))
            g = g.to(torch.float32) * scale
            mu.copy_(self.b1 * mu + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu + (1 - self.b2) * g * g)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = u + self.weight_decay * ps.to(torch.float32)
            new = (ps.to(torch.float32) - lr * u).to(p.dtype)
            if plan is not None and plan.dims[i] is not None:
                new = C.all_gather(new, plan.mesh, "data", plan.dims[i])
            p.copy_(new)
            del new  # one leaf's temporaries at a time (the largest: 1 GiB)
        return params, AdamWState(step, state.mu, state.nu), gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warmup to ``base_lr``, then cosine decay to ``min_ratio``;
    ``lr(step)`` returns an fp32 scalar tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr
