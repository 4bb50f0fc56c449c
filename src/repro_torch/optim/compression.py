"""Gradient compression with error feedback.

Port of ``repro/optim/compression.py``: microbatch gradients are
accumulated in bf16, and the quantization error is carried in an fp32
residual ("error feedback", Seide et al. 2014 / Karimireddy et al. 2019)
so the long-run gradient sum is unbiased. Enabled by
``TrainConfig(grad_compression="bf16_ef")``. A tree is a nested dict / list
/ NamedTuple of tensors (``models.params.tree_leaves`` order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_unflatten


class EFState(NamedTuple):
    residual: object  # fp32 tree like the gradients


def init_ef(params) -> EFState:
    return EFState(tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)]))


def compress(grads, ef: EFState):
    """(bf16 gradients to accumulate, new EFState): per leaf
    ``gf = fp32(g) + r; gq = bf16(gf); r' = gf - fp32(gq)``."""
    gq, res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual)):
        gf = g.to(torch.float32) + r
        q = gf.to(torch.bfloat16)
        gq.append(q)
        res.append(gf - q.to(torch.float32))
    return tree_unflatten(grads, gq), EFState(tree_unflatten(grads, res))


def decompress(grads_bf16):
    return tree_unflatten(grads_bf16, [g.to(torch.float32)
                                       for g in tree_leaves(grads_bf16)])
