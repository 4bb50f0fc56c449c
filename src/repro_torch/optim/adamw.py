"""AdamW with global-norm clipping, and the cosine learning-rate schedule.

Port of ``repro/optim/adamw.py`` for one device: the same order of
operations as the reference (fp32 moments, a global-norm clip, bias
correction, and the decoupled weight decay added to the update before the
``lr`` multiply), so ``torch.optim.AdamW``, whose order differs, is not
used. ZeRO sharding of the moments comes with the distributed slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_unflatten


class AdamWState(NamedTuple):
    step: int  # updates applied so far
    mu: dict  # fp32 first moments, a tree like params
    nu: dict  # fp32 second moments


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        leaves = tree_leaves(params)
        return AdamWState(0, tree_unflatten(params, [zeros(p) for p in leaves]),
                          tree_unflatten(params, [zeros(p) for p in leaves]))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr):
        """One AdamW step; returns (params, state, gnorm).

        Updates the parameters and the moments **in place** (under
        ``torch.no_grad()``, so parameter leaves keep ``requires_grad``) and
        returns the same trees; the reference returns new arrays.
        """
        gl = tree_leaves(grads)
        pl, ml, nl = (tree_leaves(t) for t in (params, state.mu, state.nu))
        # global-norm clip (fp32), summed leaf by leaf in tree order
        sq = [torch.sum(g.to(torch.float32) ** 2) for g in gl]
        total = sq[0]
        for x in sq[1:]:
            total = total + x
        gnorm = torch.sqrt(total)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        t = torch.tensor(float(step), dtype=torch.float32, device=gnorm.device)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                          device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                          device=t.device), t)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        for p, g, mu, nu in zip(pl, gl, ml, nl):
            g = g.to(torch.float32) * scale
            mu.copy_(self.b1 * mu + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu + (1 - self.b2) * g * g)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
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
