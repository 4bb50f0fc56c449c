"""Plain decoder: embedding, pre-norm blocks of GQA attention (qk-norm,
RoPE) and a SwiGLU MLP or a top-k mixture of experts, final norm, head.

The attention is passed in (``mra_serve.attend`` for serving,
``mra_train.attend`` for training). ``Cast`` rounds every operand of a
matrix product: ``Cast()`` leaves float32 alone; ``Cast("fp8")`` rounds
each operand to float8 e4m3 at a per-tensor scale, the precision below the
configuration's bfloat16 that the control runs in.

The MoE layer follows the configuration's semantics: softmax router in
float32, the top k by a stable descending sort (ties to the lower expert),
gates renormalised over the k, each expert's buffer holding its first
``capacity`` assignments in token order (``max(int(T k cf / E + 1), 4)``
for the T tokens of the call); assignments past it are dropped. Its aux
losses (load balance and router z) join the loss, summed over layers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


class Cast:
    """Rounding of matmul operands: None (float32) or "fp8" (e4m3, scaled
    per tensor so its largest magnitude maps to 448)."""

    def __init__(self, kind: str | None = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x):
        if self.kind is None:
            return x
        s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (x / s).to(torch.float8_e4m3fn).to(F32) * s
        return x + (q - x).detach()  # rounds the value, keeps the gradient


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (..., T, hd) rotated by positions pos (T,): the two halves of
    the head dim as (real, imaginary) parts."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                         device=x.device) / hd))
    ang = pos.to(F32)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Decoder:
    """The model of ``model`` (the configuration file's ``model`` dict)
    over ``params`` (the benchmark's weight tree)."""

    def __init__(self, model: dict, params: dict, cast: Cast | None = None):
        self.m = model
        self.p = params
        self.cast = cast or Cast()
        self.eps = float(model.get("norm_eps", 1e-6))
        self.theta = float(model.get("rope_theta", 10000.0))
        self.hd = int(model.get("head_dim") or
                      model["d_model"] // model["num_heads"])

    def mm(self, eq, a, w):
        return torch.einsum(eq, self.cast(a), self.cast(w.to(F32)))

    def embed(self, tokens):
        return self.p["embed"]["tok"][tokens].to(F32)

    def qkv(self, x, lp, pos):
        """x (B, T, d) -> q (B, H, T, hd), k / v (B, Hkv, T, hd)."""
        a = lp["attn"]
        h = rms(x, lp["ln1"]["w"], self.eps)
        q = self.mm("btd,dhk->bhtk", h, a["wq"])
        k = self.mm("btd,dhk->bhtk", h, a["wk"])
        v = self.mm("btd,dhk->bhtk", h, a["wv"])
        if self.m.get("qk_norm", False):
            q = rms(q, a["qnorm"], self.eps)
            k = rms(k, a["knorm"], self.eps)
        return rope(q, pos, self.theta), rope(k, pos, self.theta), v

    def after_attention(self, x, o, lp):
        """The residual, the FFN and its residual: (x, aux loss)."""
        x = x + self.mm("bhtk,hkd->btd", o, lp["attn"]["wo"])
        h = rms(x, lp["ln2"]["w"], self.eps)
        if "moe" in lp:
            out, aux = self.moe(h, lp["moe"])
        else:
            mp = lp["mlp"]
            g = self.mm("btd,df->btf", h, mp["wg"])
            u = self.mm("btd,df->btf", h, mp["wi"])
            out = self.mm("btf,fd->btd", F.silu(g) * u, mp["wo"])
            aux = x.new_zeros(())
        return x + out, aux

    def moe(self, h, mp):
        spec = self.m["moe"]
        B, T, d = h.shape
        x = h.reshape(B * T, d)
        n, E, k = x.shape[0], spec["num_experts"], spec["top_k"]
        cf = float(spec.get("capacity_factor", 1.25))
        logits = x @ mp["router"].to(F32)
        probs = torch.softmax(logits, -1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = top.values[:, :k]
        gates = gates / gates.sum(-1, keepdim=True)
        idx = top.indices[:, :k]
        cap = max(int(n * k * cf / E + 1), 4)
        flat = idx.reshape(-1)                       # assignment t*k + j
        onehot = F.one_hot(flat, E)
        rank = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
        keep = rank < cap
        out = torch.zeros_like(x)
        tok = torch.arange(n * k, device=x.device) // k
        gflat = gates.reshape(-1)
        for e in range(E):
            sel = torch.nonzero((flat == e) & keep).squeeze(-1)
            if sel.numel() == 0:
                continue
            xe = x[tok[sel]]
            g = self.mm("td,df->tf", xe, mp["wg"][e])
            u = self.mm("td,df->tf", xe, mp["wi"][e])
            y = self.mm("tf,fd->td", F.silu(g) * u, mp["wo"][e])
            out = out.index_add(0, tok[sel], y * gflat[sel][:, None])
        me = probs.mean(0)
        ce = F.one_hot(idx, E).to(F32).sum(1).mean(0)
        aux = (E * torch.sum(me * ce) * float(spec.get("aux_loss_coef", 1e-2))
               + torch.mean(torch.logsumexp(logits, -1) ** 2)
               * float(spec.get("router_z_coef", 1e-3)))
        return out.reshape(B, T, d), aux

    def logits(self, x):
        """x (..., d) after the last layer -> logits over the vocab."""
        h = rms(x, self.p["ln_f"]["w"], self.eps)
        e = self.p["embed"]
        w = e["tok"].T if self.m.get("tie_embeddings", False) else e["head"]
        out = torch.einsum("...d,dv->...v", self.cast(h), self.cast(w.to(F32)))
        return out[..., : self.m["vocab"]]
