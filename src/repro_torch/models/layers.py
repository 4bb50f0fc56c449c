"""Layers of the transformer families (plain functions on tensors).

Port of ``repro/models/layers.py``: RMSNorm and LayerNorm, RoPE, the GQA
projection with optional qkv-bias / qk-norm, the full-sequence attention
block, the SwiGLU and GELU MLPs, the token embedding (with learned
positions) / LM head, the LM loss and the remat wrapper. Weights are cast
to the activation dtype at use and norm weights to fp32, as in the
reference. Two of the reference's defaults differ from torch's and are
kept: ``jax.nn.gelu`` is the tanh approximation, and LayerNorm takes the
biased variance in fp32 at ``cfg.norm_eps``.

Under an active mesh (``distributed/mesh_utils.use_mesh``) each layer
holds the rank's weight blocks (``distributed/sharding.shard_params``) and
splits its work over the "model" axis by the placement of those weights
(``tp_layout``), Megatron-style: q / k / v column-parallel over heads and
``wo`` row-parallel then an all-reduce; the MLP's ``wi`` / ``wg`` over
d_ff and ``wo`` back; the vocab-padded embedding as a masked local lookup
and an all-reduce; the logits over the vocab, with a vocab-parallel
cross-entropy (``lm_nll``) and an all-gather before sampling
(``gather_vocab``). Replicated activations and weights enter the split
work through ``collectives.copy_to`` (an all-reduce of their gradients)
and leave it through ``collectives.reduce_from``; a dimension the rules
leave replicated takes no collective. When the query heads divide the
model axis but the kv heads do not, the attention weights are gathered
and attention runs replicated.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec, self_attention
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh_utils
from repro_torch.distributed.sharding import logical_to_pspec


class TPLayout(NamedTuple):
    """How a layer splits its work over the active mesh's "model" axis
    (the placement of its weights); all False without a mesh."""

    mesh: object
    heads: bool  # q / k / v / wo over heads (the kv heads divide)
    q_only: bool  # wq / wo split, wk / wv not: gathered, attention replicated
    ff: bool  # the MLP over d_ff
    vocab: bool  # the embedding and the logits over the vocab

    def index(self) -> int:
        return self.mesh.index("model")


def tp_layout(cfg: ModelConfig) -> TPLayout:
    mesh = mesh_utils.get_mesh()
    if C.axis_size(mesh, "model") == 1:
        return TPLayout(mesh, False, False, False, False)

    def split(shape, axes, dim):
        return logical_to_pspec(shape, axes, mesh)[dim] == "model"

    d, hd = cfg.d_model, cfg.hd
    q = split((d, cfg.padded_heads, hd), ("d_model", "heads", None), 1)
    kv = split((d, cfg.kv_heads, hd), ("d_model", "kv_heads", None), 1)
    ff = split((d, cfg.d_ff), ("d_model", "d_ff"), 1)
    vocab = split((cfg.padded_vocab, d), ("vocab", "d_model"), 0)
    return TPLayout(mesh, q and kv, q and not kv, ff, vocab)


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


def attn_params(p, cfg: ModelConfig, tp: TPLayout) -> dict:
    """The attention weights as a layer uses them under ``tp``: the qk
    norms entering the head-split work (``copy_to``), or, when only the
    query heads split, wq / bq / wo gathered whole."""
    if tp.q_only:
        p = dict(p, wq=C.gather_from(p["wq"], tp.mesh, "model", 1),
                 wo=C.gather_from(p["wo"], tp.mesh, "model", 0))
        if "bq" in p:
            p["bq"] = C.gather_from(p["bq"], tp.mesh, "model", 0)
    elif tp.heads and cfg.qk_norm:
        p = dict(p, qnorm=C.copy_to(p["qnorm"], tp.mesh),
                 knorm=C.copy_to(p["knorm"], tp.mesh))
    return p


def attn_input(x, tp: TPLayout):
    """The normed input of the attention's projections (enters the
    head-split work)."""
    return C.copy_to(x, tp.mesh) if tp.heads else x


def attn_output(o, p, cfg: ModelConfig, tp: TPLayout):
    """o (B, H_loc, S, hd) -> (B, S, d): TP head padding masked, ``wo``,
    and the sum over the head blocks."""
    if cfg.padded_heads != cfg.num_heads:
        n = o.shape[1]
        h0 = tp.index() * n if tp.heads else 0
        mask = head_mask(cfg, o.device)[h0:h0 + n]
        o = o * mask[None, :, None, None].to(o.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(o.dtype))
    return C.reduce_from(out, tp.mesh) if tp.heads else out


def qkv_project(x, p, cfg: ModelConfig, positions):
    """x (B,S,d) -> q (B,H,S,hd), k/v (B,Hkv,S,hd), RoPE applied (H and
    Hkv the rank's blocks under a mesh)."""
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
    tp = tp_layout(cfg)
    p = attn_params(p, cfg, tp)
    q, k, v = qkv_project(attn_input(x, tp), p, cfg, positions)
    k, v = expand_kv_slots(k, v, cfg)
    o = self_attention(q, k, v, spec, causal=cfg.causal, key_mask=key_mask)
    return attn_output(o, p, cfg, tp)


def mlp_block(x, p, cfg: ModelConfig):
    adt = x.dtype
    tp = tp_layout(cfg)
    if tp.ff:
        x = C.copy_to(x, tp.mesh)
    if cfg.act == "swiglu":
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(adt))
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(adt))
        out = torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["wo"].to(adt))
        return C.reduce_from(out, tp.mesh) if tp.ff else out
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(adt)) + p["bi"].to(adt)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    out = torch.einsum("bsf,fd->bsd", h, p["wo"].to(adt))
    if tp.ff:
        out = C.reduce_from(out, tp.mesh)
    return out + p["bo"].to(adt)


def embed(tokens, p, cfg: ModelConfig, positions=None):
    """Token embedding, plus the learned position rows (positions: (S,) or
    (B, S); default 0 .. S - 1) under ``pos="learned"``. Vocab-split: each
    rank looks up the tokens in its rows and the rows are summed (one
    nonzero term per token: exact)."""
    tp = tp_layout(cfg)
    if tp.vocab:
        n = p["tok"].shape[0]
        local = tokens - tp.index() * n
        ok = (local >= 0) & (local < n)
        rows = p["tok"][local.clamp(0, n - 1)]
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        x = C.reduce_from(rows, tp.mesh).to(cfg.adt)
    else:
        x = p["tok"][tokens].to(cfg.adt)
    if cfg.pos == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = x + p["pos"][positions].to(cfg.adt)
    return x


def unembed(x, p, cfg: ModelConfig):
    """Logits (B, S, V): under a vocab-split mesh the rank's V / |model|
    columns (``gather_vocab`` makes them whole)."""
    tp = tp_layout(cfg)
    if tp.vocab:
        x = C.copy_to(x, tp.mesh)
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))


def gather_vocab(logits, cfg: ModelConfig):
    """``unembed``'s logits over the whole (padded) vocab."""
    tp = tp_layout(cfg)
    if not tp.vocab:
        return logits
    return C.gather_from(logits, tp.mesh, "model", -1)


def lm_nll(logits, targets, cfg: ModelConfig):
    """Per-position NLL with padded-vocab masking, in fp32.
    logits (..., padded_vocab) — or the rank's vocab columns under a
    vocab-split mesh: a vocab-parallel cross-entropy —, targets (...) int."""
    tp = tp_layout(cfg)
    lf = logits.to(torch.float32)
    n = lf.shape[-1]
    v0 = tp.index() * n if tp.vocab else 0
    if cfg.padded_vocab != cfg.vocab:
        pad_ok = torch.arange(v0, v0 + n, device=lf.device) < cfg.vocab
        lf = torch.where(pad_ok, lf, -1e9)
    if not tp.vocab:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, targets[..., None].long())[..., 0]
        return lse - ll
    m = C.all_reduce(lf.detach().amax(-1), tp.mesh, "model", "max")
    se = C.reduce_from(torch.exp(lf - m[..., None]).sum(-1), tp.mesh)
    local = targets.long() - v0
    ok = (local >= 0) & (local < n)
    ll = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    ll = C.reduce_from(torch.where(ok, ll, torch.zeros_like(ll)), tp.mesh)
    return torch.log(se) + m - ll


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
