"""Layers of the dense decoder (plain functions on tensors).

Port of ``repro/models/layers.py`` for the dense family: RMSNorm, RoPE, the
GQA projection with optional qkv-bias / qk-norm, the SwiGLU MLP, and the
token embedding / LM head. Weights are cast to the activation dtype at use
and norm weights to fp32, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


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
