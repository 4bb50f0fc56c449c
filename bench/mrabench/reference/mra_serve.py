"""MRA-2 attention as served, written per query row from its definition.

A row at position p sees the keys at positions <= p, in pages of b keys
(page y holds positions y·b .. y·b + b - 1). Its own page is attended
exactly (keys <= p). Of the pages before it, the m - 1 with the highest
coarse score q·k̄_y·scale (k̄_y the page's key mean; ties to the lower
page) are attended exactly too; every other earlier page y enters the
softmax once, as b keys that all score q·k̄_y and carry the value mean
v̄_y. With m or fewer pages the row is exact attention. That is the
program's serving attention at levels = 2 with no page evicted, whatever
the chunk a row was prefilled in.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG = float("-inf")


def attend(q, k, v, *, block: int, m: int, scale: float,
           max_elems: int = 1 << 27):
    """q (Hq, T, D), k / v (Hkv, T, D) of one sequence, fp32 ->
    (Hq, T, D). Rows go in groups of whole pages, each group's scores at
    most ``max_elems`` entries."""
    Hq, T, D = q.shape
    Hkv = k.shape[0]
    G = Hq // Hkv
    b = block
    nb = -(-T // b)
    pad = nb * b - T
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    cnt = torch.clamp(T - torch.arange(nb, device=q.device) * b, 0, b).to(F32)
    kbar = kp.reshape(Hkv, nb, b, D).sum(2) / cnt[None, :, None]
    vbar = vp.reshape(Hkv, nb, b, D).sum(2) / cnt[None, :, None]
    qg = q.reshape(Hkv, G, T, D)
    out = torch.empty((Hkv, G, T, D), dtype=F32, device=q.device)
    x0 = 0
    while x0 < nb:
        x1 = x0 + 1
        while x1 < nb and Hq * (x1 + 1 - x0) * b * (x1 + 1) * b <= max_elems:
            x1 += 1
        r0, r1 = x0 * b, min(x1 * b, T)
        kn = min(x1 * b, T)
        rows = torch.arange(r0, r1, device=q.device)
        qr = qg[:, :, r0:r1]                                  # (Hkv,G,R,D)
        s = torch.einsum("hgrd,hkd->hgrk", qr, k[:, :kn]) * scale
        c = torch.einsum("hgrd,hyd->hgry", qr, kbar[:, :x1]) * scale
        own = rows // b
        page = torch.arange(x1, device=q.device)
        past = page[None, :] < own[:, None]                   # (R, x1)
        cp = torch.where(past, c, NEG)
        top = torch.sort(cp, dim=-1, descending=True, stable=True)
        take = min(m - 1, x1)
        chosen = torch.zeros_like(cp, dtype=torch.bool)
        chosen.scatter_(-1, top.indices[..., :take],
                        top.values[..., :take] > NEG)
        chosen |= (page[None, :] == own[:, None])
        kpage = torch.arange(kn, device=q.device) // b
        exact = (chosen[..., kpage]
                 & (torch.arange(kn, device=q.device)[None, :]
                    <= rows[:, None]))
        bg = past & ~chosen
        s = torch.where(exact, s, NEG)
        cb = torch.where(bg, c, NEG)
        mx = torch.maximum(s.amax(-1), cb.amax(-1))[..., None]
        ps = torch.exp(s - mx)
        pb = torch.exp(cb - mx) * cnt[:x1]
        num = (torch.einsum("hgrk,hkd->hgrd", ps, v[:, :kn])
               + torch.einsum("hgry,hyd->hgrd", pb, vbar[:, :x1]))
        den = ps.sum(-1) + pb.sum(-1)
        out[:, :, r0:r1] = num / den[..., None]
        x0 = x1
    return out.reshape(Hq, T, D)


@torch.no_grad()
def served_logits(dec, tokens, at, *, block: int, m: int):
    """Logits (len(at), V) of the decoder ``dec`` at positions ``at`` of
    one sequence ``tokens`` (T,), under the served attention."""
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    x = dec.embed(tokens[None])
    scale = 1.0 / dec.hd ** 0.5
    for lp in dec.p["layers"]:
        q, k, v = dec.qkv(x, lp, pos)
        o = attend(dec.cast(q[0]), dec.cast(k[0]), dec.cast(v[0]),
                   block=block, m=m, scale=scale)
        x, _ = dec.after_attention(x, o[None], lp)
    return dec.logits(x[0, at])
