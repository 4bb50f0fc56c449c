"""Layers of the dense decoder (plain functions on tensors).

Port of ``repro/models/layers.py`` for the dense family: RMSNorm, RoPE, the
GQA projection with optional qkv-bias / qk-norm, the full-sequence
attention block, the SwiGLU MLP, the token embedding / LM head, the LM
loss and the remat wrapper. Weights are cast to the activation dtype at use
and norm weights to fp32, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec, self_attention


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt)


def apply_norm(x, p, cfg: ModelConfig):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm={cfg.norm!r}: layernorm comes with the encoder families")
    return rms_norm(x, p["w"], cfg.norm_eps)


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x (B, H, S, Hd); positions (S,) or (B, S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs
    if ang.ndim == 3:  # per-batch positions: insert the head axis
        ang = ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def head_mask(cfg: ModelConfig, device=None):
    """(padded_heads,) True for real heads, False for TP padding."""
    return torch.arange(cfg.padded_heads, device=device) < cfg.num_heads


def qkv_project(x, p, cfg: ModelConfig, positions):
    """x (B,S,d) -> q (B,H,S,hd), k/v (B,Hkv,S,hd), RoPE applied."""
    adt = x.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(adt))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(adt))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(adt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(adt)[None, :, None, :]
        k = k + p["bk"].to(adt)[None, :, None, :]
        v = v + p["bv"].to(adt)[None, :, None, :]
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"], cfg.norm_eps)
        k = rms_norm(k, p["knorm"], cfg.norm_eps)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def expand_kv_slots(k, v, cfg: ModelConfig):
    """Expand the KV head axis to cfg.kv_slots (TP padding; weights shared)."""
    rep = cfg.kv_slots // cfg.kv_heads
    if rep == 1:
        return k, v
    return (torch.repeat_interleave(k, rep, dim=1),
            torch.repeat_interleave(v, rep, dim=1))


def attn_block(x, p, cfg: ModelConfig, *, spec: Optional[AttentionSpec] = None,
               key_mask=None, positions=None):
    """Full-sequence attention block (training). x (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    spec = spec or cfg.attn_spec
    q, k, v = qkv_project(x, p, cfg, positions)
    k, v = expand_kv_slots(k, v, cfg)
    o = self_attention(q, k, v, spec, causal=cfg.causal, key_mask=key_mask)
    if cfg.padded_heads != cfg.num_heads:
        o = o * head_mask(cfg, o.device)[None, :, None, None].to(o.dtype)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))


def mlp_block(x, p, cfg: ModelConfig):
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act={cfg.act!r}: only swiglu is ported")
    adt = x.dtype
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(adt))
    g = torch.einsum("bsd,df->bsf", x, p["wg"].to(adt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["wo"].to(adt))


def embed(tokens, p, cfg: ModelConfig):
    return p["tok"][tokens].to(cfg.adt)


def unembed(x, p, cfg: ModelConfig):
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))


def lm_nll(logits, targets, cfg: ModelConfig):
    """Per-position NLL with padded-vocab masking, in fp32.
    logits (..., padded_vocab), targets (...) int."""
    lf = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:
        pad_ok = torch.arange(cfg.padded_vocab, device=lf.device) < cfg.vocab
        lf = torch.where(pad_ok, lf, -1e9)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return lse - ll


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under the config's remat policy: "full" recomputes its forward
    in the backward (non-reentrant activation checkpointing)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        def wrapped(*args, **kw):
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return wrapped
    raise NotImplementedError(
        f"remat={cfg.remat!r}: only 'none' and 'full' are ported (the "
        "reference's 'dots' policy has no port yet)")
