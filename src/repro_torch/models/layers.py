"""Layers of the transformer families (plain functions on tensors).

Port of ``repro/models/layers.py``: RMSNorm and LayerNorm, RoPE, the GQA
projection with optional qkv-bias / qk-norm, the full-sequence attention
block, the SwiGLU and GELU MLPs, the token embedding (with learned
positions) / LM head, the LM loss and the remat wrapper. Weights are cast
to the activation dtype at use and norm weights to fp32, as in the
reference. Two of the reference's defaults differ from torch's and are
kept: ``jax.nn.gelu`` is the tanh approximation, and LayerNorm takes the
biased variance in fp32 at ``cfg.norm_eps``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec, self_attention


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt)


def layer_norm(x, w, b, eps=1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def apply_norm(x, p, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
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
    adt = x.dtype
    if cfg.act == "swiglu":
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(adt))
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(adt))
        return torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["wo"].to(adt))
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(adt)) + p["bi"].to(adt)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return (torch.einsum("bsf,fd->bsd", h, p["wo"].to(adt))
            + p["bo"].to(adt))


def embed(tokens, p, cfg: ModelConfig, positions=None):
    """Token embedding, plus the learned position rows (positions: (S,) or
    (B, S); default 0 .. S - 1) under ``pos="learned"``."""
    x = p["tok"][tokens].to(cfg.adt)
    if cfg.pos == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = x + p["pos"][positions].to(cfg.adt)
    return x


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


def saves_product(op, args) -> bool:
    """Whether the ``"dots"`` policy keeps the output of the aten op ``op``
    on ``args``: a product with no batch dimension (``mm``, ``addmm``, or a
    ``bmm`` of batch 1, which is what ``einsum`` makes of "bsd,df->bsf").
    These are the reference's ``checkpoint_dots_with_no_batch_dims``: the
    q/k/v/o projections, the dense MLP's products and the router logits.
    A product with a batch (attention scores, the experts' "ecd,edf->ecf")
    and every other op is recomputed: nothing a CUDA kernel writes through
    ``ctypes`` into a ``torch.empty`` buffer, which the dispatcher never
    sees, is kept."""
    aten = torch.ops.aten
    return op in (aten.mm.default, aten.addmm.default) or (
        op is aten.bmm.default and args[0].shape[0] == 1)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if saves_product(op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under the config's remat policy (non-reentrant activation
    checkpointing): "full" recomputes its whole forward in the backward,
    "dots" keeps the products ``saves_product`` names and recomputes the
    rest (the block-sparse attention too, as the reference's policy does
    around its kernel)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        def wrapped(*args, **kw):
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return wrapped
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)

        def wrapped(*args, **kw):
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=context, **kw)
        return wrapped
    raise ValueError(f"remat={cfg.remat!r}: expected 'none', 'full' or "
                     "'dots'")
