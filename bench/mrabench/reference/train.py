"""Plain training steps: the decoder's next-token loss (mean NLL plus the
MoE aux losses) under the trained MRA-2 attention, its gradients by
autograd, and AdamW as the configuration states it: global-norm clipping,
fp32 moments, bias correction, decoupled weight decay added to the update
before the learning-rate multiply."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import mra_train
from .decoder import Decoder

F32 = torch.float32


def loss(dec: Decoder, tokens, targets, *, head_rows: int = 2048):
    """Mean NLL of ``targets`` plus the aux losses; tokens / targets
    (B, S). Each layer, and the head in blocks of ``head_rows`` positions,
    is recomputed in the backward."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    att = dec.m["attention"]
    scale = 1.0 / dec.hd ** 0.5

    def layer(x, lp):
        q, k, v = dec.qkv(x, lp, pos)
        o = mra_train.attend(dec.cast(q), dec.cast(k), dec.cast(v),
                             block=att["block_size"],
                             per_row=att["blocks_per_row"], scale=scale)
        return dec.after_attention(x, o, lp)

    x = dec.embed(tokens)
    aux = x.new_zeros(())
    for lp in dec.p["layers"]:
        x, a = checkpoint(layer, x, lp, use_reentrant=False)
        aux = aux + a

    def nll(xs, ts):
        lg = dec.logits(xs)
        return (torch.logsumexp(lg, -1)
                - torch.gather(lg, -1, ts[..., None])[..., 0]).sum()

    total = x.new_zeros(())
    for s0 in range(0, S, head_rows):
        total = total + checkpoint(nll, x[:, s0:s0 + head_rows],
                                   targets[:, s0:s0 + head_rows],
                                   use_reentrant=False)
    mean = total / (B * S)
    return mean + aux, mean


class AdamW:
    def __init__(self, b1, b2, eps, weight_decay, clip_norm):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm

    def init(self, leaves):
        return {"step": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, leaves, grads, state, lr: float):
        gnorm = torch.sqrt(sum(torch.sum(g.to(F32) ** 2) for g in grads))
        scale = torch.clamp(self.clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        state["step"] += 1
        t = state["step"]
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            g = g.to(F32) * scale
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p
            p.sub_(lr * u)
        return gnorm


def first_grad_norms(nus, b2: float) -> torch.Tensor:
    """|g| of each leaf's first clipped gradient, from its second moment
    after one step (nu = (1 - b2) g²): one float64 tensor on the moments'
    device, queued without a sync."""
    sums = torch.stack([nu.sum(dtype=torch.float64) for nu in nus])
    return torch.sqrt(sums / (1.0 - b2))
