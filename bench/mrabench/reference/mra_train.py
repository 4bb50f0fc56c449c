"""MRA-2 attention as trained (causal, one call over the whole sequence),
written from its definition.

The sequence of n = nb·b positions is cut into nb blocks. Coarse scores
are block means: c[x, y] = q̄_x·k̄_y·scale, allowed for y <= x. The
budget is m = min(blocks_per_row·nb, nb(nb+1)/2) (x, y) pairs of the
whole grid, per (sequence, head): the diagonal pairs always, then the
allowed pairs of highest coarse score (the selection does not carry a
gradient; ties to the lower flat index x·nb + y). A query at position i
of block x attends exactly the keys j <= i of its selected pairs; every
other allowed block y of its row enters the softmax as b keys that all
score c[x, y] and carry the value mean v̄_y.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
NEG = float("-inf")


def _one(qg, k, v, *, block: int, per_row: int, scale: float):
    """One sequence: qg (Hkv, G, n, D), k / v (Hkv, n, D)."""
    Hkv, G, n, D = qg.shape
    b = block
    nb = n // b
    q_ds = qg.reshape(Hkv, G, nb, b, D).mean(3)
    k_ds = k.reshape(Hkv, nb, b, D).mean(2)
    v_ds = v.reshape(Hkv, nb, b, D).mean(2)
    c = torch.einsum("hgxd,hyd->hgxy", q_ds, k_ds) * scale
    ar = torch.arange(nb, device=qg.device)
    allowed = ar[:, None] >= ar[None, :]
    diag = ar[:, None] == ar[None, :]
    m = min(per_row * nb, nb * (nb + 1) // 2)
    score = torch.where(allowed, c.detach(), NEG)
    score = torch.where(diag, torch.full_like(score, float("inf")), score)
    top = torch.sort(score.reshape(Hkv, G, nb * nb), dim=-1, descending=True,
                     stable=True).indices[..., :m]
    sel = torch.zeros((Hkv, G, nb * nb), dtype=torch.bool, device=qg.device)
    sel.scatter_(-1, top, True)
    sel = sel.reshape(Hkv, G, nb, nb) & allowed
    bg = allowed & ~sel
    pos = torch.arange(n, device=qg.device)
    blk = pos // b
    exact = sel[:, :, blk][:, :, :, blk] & (pos[None, :] <= pos[:, None])
    s = torch.einsum("hgid,hjd->hgij", qg, k) * scale
    s = torch.where(exact, s, NEG)
    cb = torch.where(bg, c, NEG)[:, :, blk]                 # (Hkv,G,n,nb)
    mx = torch.maximum(s.amax(-1), cb.amax(-1)).detach()[..., None]
    ps = torch.exp(s - mx)
    pb = torch.exp(cb - mx) * b
    num = (torch.einsum("hgij,hjd->hgid", ps, v)
           + torch.einsum("hgiy,hyd->hgid", pb, v_ds))
    den = ps.sum(-1) + pb.sum(-1)
    return num / den[..., None]


def attend(q, k, v, *, block: int, per_row: int, scale: float):
    """q (B, Hq, n, D), k / v (B, Hkv, n, D), n a multiple of ``block``
    -> (B, Hq, n, D); each sequence's attention is recomputed in the
    backward (its n x n scores are the largest tensors of the step)."""
    B, Hq, n, D = q.shape
    Hkv = k.shape[1]
    outs = []
    for i in range(B):
        qg = q[i].reshape(Hkv, Hq // Hkv, n, D)
        o = checkpoint(_one, qg, k[i], v[i], block=block, per_row=per_row,
                       scale=scale, use_reentrant=False)
        outs.append(o.reshape(Hq, n, D))
    return torch.stack(outs)
