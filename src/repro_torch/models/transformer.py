"""Dense GQA decoder: training forward and loss, serving cache and steps.

Port of the dense family of ``repro/models/transformer.py`` (DESIGN.md §9):
the full-sequence ``forward`` / ``loss_fn`` that training runs (the layers
are a list here, so the reference's ``scan`` is a loop, each layer under
the config's remat policy), and the serving half — ``cache_specs``
(two-level ring-paged layout, with or without the int8 KV cache),
``layer_cache_kinds``, ``prefill_chunk`` and ``decode_step``. The
whole-prompt ``prefill`` has no port yet.

Unlike the reference, ``prefill_chunk`` and ``decode_step`` update the
cache tensors **in place** (and return the same dict): a slot that is
frozen for the call (``num_valid == 0``, ``active == False``) has every row
of its K/V, scales, pyramid sums, page-table entries and length left
bit-identical.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (
    MRA_KINDS,
    chunk_attention,
    decode_attention,
)
from repro_torch.core.mra_decode import (
    PyramidState,
    quantize_kv,
    ring_pyramid_update,
)

from . import layers as L
from .params import TensorSpec


def _layer_fwd(x, p, cfg: ModelConfig, key_mask):
    h = L.apply_norm(x, p["ln1"], cfg)
    x = x + L.attn_block(h, p["attn"], cfg, key_mask=key_mask)
    h = L.apply_norm(x, p["ln2"], cfg)
    return x + L.mlp_block(h, p["mlp"], cfg)


def forward(params, cfg: ModelConfig, batch, *, key_mask=None):
    """Full-sequence forward of the dense decoder.

    batch: {"tokens": (B, S) int}; key_mask: optional (B, S) bool.
    Returns (logits (B, S, padded_vocab) in the activation dtype, aux loss
    (a zero fp32 scalar: the dense family has none)).
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; only the dense decoder is")
    x = L.embed(batch["tokens"], params["embed"], cfg)
    body = L.remat_wrap(_layer_fwd, cfg)
    for p in params["layers"]:
        x = body(x, p, cfg, key_mask)
    x = L.apply_norm(x, params["ln_f"], cfg)
    logits = L.unembed(x, params["embed"], cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(params, cfg: ModelConfig, batch, *, key_mask=None):
    """Mean next-token NLL. Returns (loss + aux, {"loss", "aux_loss", "nll"})."""
    logits, aux = forward(params, cfg, batch, key_mask=key_mask)
    loss = L.lm_nll(logits, batch["targets"], cfg).mean()
    metrics = {"loss": loss, "aux_loss": aux, "nll": loss}
    return loss + aux, metrics


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The serving cache as TensorSpecs (per-layer lists, as the reference).

    k/v (B, Hkv, S, hd) at the activation dtype (int8 with per-token scales
    under ``kv_quant``); under the MRA kinds also the fp32 pyramid block
    sums (B, Hkv, nb, hd) per layer and the shared ring page table (B, nb)
    (physical page -> logical block, -1 = never written).
    """
    if cfg.attention.levels >= 3:
        raise NotImplementedError(
            "the H-level pyramid (levels >= 3) comes with its own slice")
    hd, Hkv, Lx = cfg.hd, cfg.kv_heads, cfg.num_layers
    mra = cfg.attention.kind in MRA_KINDS
    quant = cfg.attention.kv_quant and mra
    kv = TensorSpec((batch, Hkv, max_len, hd),
                    torch.int8 if quant else cfg.adt, "zeros")
    c = {"k": [kv] * Lx, "v": [kv] * Lx,
         "lengths": TensorSpec((batch,), torch.int32, "zeros")}
    if quant:
        sc = TensorSpec((batch, Hkv, max_len), torch.float32, "zeros")
        c["k_scale"] = [sc] * Lx
        c["v_scale"] = [sc] * Lx
    if mra:
        nb = max_len // cfg.attention.block_size
        pyr = TensorSpec((batch, Hkv, nb, hd), torch.float32, "zeros")
        c["pyr_k"] = [pyr] * Lx
        c["pyr_v"] = [pyr] * Lx
        c["page_blocks"] = TensorSpec((batch, nb), torch.int32, "fill", -1)
    return c


def layer_cache_kinds(cfg: ModelConfig):
    """Per-layer serving-cache kinds: ring-paged under MRA, plain KV else."""
    kind = "paged_kv" if cfg.attention.kind in MRA_KINDS else "kv"
    return [kind] * cfg.num_layers


def _residual_attention(x, o, p, cfg: ModelConfig):
    if cfg.padded_heads != cfg.num_heads:
        o = o * L.head_mask(cfg, o.device)[None, :, None, None].to(o.dtype)
    x = x + torch.einsum("bhsk,hkd->bsd", o, p["attn"]["wo"].to(x.dtype))
    h = L.apply_norm(x, p["ln2"], cfg)
    return x + L.mlp_block(h, p["mlp"], cfg)


@torch.no_grad()
def prefill_chunk(params, cfg: ModelConfig, cache, tokens, num_valid, *,
                  all_logits: bool = False):
    """Chunked batched prefill: C prompt tokens per slot, ragged lengths.

    Every prefilling slot advances by up to C tokens in one call: the
    chunk's K/V (and pyramid block sums) are written into the cache at the
    slot's offset, then the chunk's queries attend the updated cache. A
    chunk token that starts a new block recycles its ring page (drops the
    evicted block's sums first).

    Args:
      tokens: (B, C) int prompt chunk per slot (padding arbitrary).
      num_valid: (B,) count of real tokens per slot; 0 freezes the slot.
      all_logits: return logits at every chunk position, not just the last
        valid one.

    Returns:
      (logits (B, V) — or (B, C, V) with ``all_logits`` —, cache), the cache
      updated in place.
    """
    B, C = tokens.shape
    dev = tokens.device
    offsets = cache["lengths"]
    positions = offsets[:, None] + torch.arange(C, dtype=offsets.dtype,
                                                device=dev)  # (B, C)
    tv = torch.arange(C, device=dev) < num_valid[:, None]  # token validity
    lengths_new = offsets + num_valid.to(offsets.dtype)
    x = L.embed(tokens, params["embed"], cfg)
    paged = "page_blocks" in cache
    bs = cfg.attention.block_size
    b_idx2 = torch.arange(B, device=dev)[:, None].expand(B, C)
    frozen = (num_valid == 0)[:, None, None, None]

    def scatter_tokens(arr, vals):
        """Masked in-place write: vals (B, Hkv, C, ...) -> arr (B, Hkv, S, ...)."""
        widx = positions % arr.shape[2]  # distinct per lane while C <= S
        vt = vals.transpose(1, 2).to(arr.dtype)  # (B, C, Hkv, ...)
        m = tv[:, :, None, None] if vt.ndim == 4 else tv[:, :, None]
        arr[b_idx2, :, widx] = torch.where(m, vt, arr[b_idx2, :, widx])
        return arr

    if paged:
        npages = cache["page_blocks"].shape[1]
        page = (positions // bs) % npages  # (B, C)
        # dense one-hot token->page map: a deterministic segment sum
        ind_b = (page[:, :, None] == torch.arange(npages, device=dev)) & tv[:, :, None]
        ind = ind_b.to(torch.float32)
        # a chunk token that starts a block evicts the page's previous owner
        fresh = (ind_b & ((positions % bs) == 0)[:, :, None]).any(1)
        touched = ind_b.any(1)  # (B, npages)
        blk_new = torch.where(ind_b, (positions // bs)[:, :, None], -1).amax(1)
        pb = cache["page_blocks"]
        pb.copy_(torch.where(touched, blk_new.to(pb.dtype), pb))

    for i, p in enumerate(params["layers"]):
        h = L.apply_norm(x, p["ln1"], cfg)
        q, k_new, v_new = L.qkv_project(h, p["attn"], cfg, positions)
        ks = vs = None
        if "k_scale" in cache:  # int8 KV cache
            kq, ksc = quantize_kv(k_new)
            vq, vsc = quantize_kv(v_new)
            ks = scatter_tokens(cache["k_scale"][i], ksc)
            vs = scatter_tokens(cache["v_scale"][i], vsc)
            k_write, v_write = kq, vq
        else:
            k_write, v_write = k_new, v_new
        kc = scatter_tokens(cache["k"][i], k_write)
        vc = scatter_tokens(cache["v"][i], v_write)
        pyramid = None
        if paged:
            base_k, base_v = cache["pyr_k"][i], cache["pyr_v"][i]
            f4 = fresh[:, None, :, None]
            pk = torch.where(f4, 0.0, base_k) + torch.einsum(
                "bcy,bhcd->bhyd", ind, k_new.to(torch.float32))
            pv = torch.where(f4, 0.0, base_v) + torch.einsum(
                "bcy,bhcd->bhyd", ind, v_new.to(torch.float32))
            base_k.copy_(torch.where(frozen, base_k, pk))
            base_v.copy_(torch.where(frozen, base_v, pv))
            pyramid = PyramidState(base_k, base_v)
        o = chunk_attention(
            q, kc, vc, lengths_new, positions, cfg.attn_spec, pyramid=pyramid,
            page_blocks=cache.get("page_blocks"), k_scale=ks, v_scale=vs)
        x = _residual_attention(x, o, p, cfg)
    x = L.apply_norm(x, params["ln_f"], cfg)
    if all_logits:
        logits = L.unembed(x, params["embed"], cfg)  # (B, C, V)
    else:
        last = torch.clamp(num_valid.to(torch.long) - 1, 0, C - 1)
        x_last = x[torch.arange(B, device=dev), last]  # (B, d)
        logits = L.unembed(x_last[:, None], params["embed"], cfg)[:, 0]
    cache["lengths"].copy_(lengths_new)
    return logits, cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, tokens, active=None):
    """One decode step. tokens (B,) int -> (logits (B, V), cache).

    ``active`` (B,) bool restricts the step to a subset of slots: inactive
    slots' cache rows (KV, scales, pyramid, page table, length) stay
    bit-identical and their logits are garbage for the caller to ignore.
    ``None`` = all active. The write position wraps modulo the physical
    cache, so a stream past capacity recycles its oldest background page.
    The cache is updated in place.
    """
    B = tokens.shape[0]
    dev = tokens.device
    act = (torch.ones((B,), dtype=torch.bool, device=dev) if active is None
           else active)
    lengths = cache["lengths"] + act.to(cache["lengths"].dtype)
    x = L.embed(tokens[:, None], params["embed"], cfg)
    b_idx = torch.arange(B, device=dev)
    paged = "page_blocks" in cache
    pos = lengths - 1  # the new token's position (-1 for an idle empty slot)
    am2, am3 = act[:, None], act[:, None, None]
    for i, p in enumerate(params["layers"]):
        h = L.apply_norm(x, p["ln1"], cfg)
        q, k_new, v_new = L.qkv_project(h, p["attn"], cfg, pos[:, None])
        kc, vc = cache["k"][i], cache["v"][i]
        widx = pos % kc.shape[2]
        ks = vs = None
        if "k_scale" in cache:  # int8 KV cache
            kq, ksc = quantize_kv(k_new[:, :, 0])
            vq, vsc = quantize_kv(v_new[:, :, 0])
            ks, vs = cache["k_scale"][i], cache["v_scale"][i]
            ks[b_idx, :, widx] = torch.where(am2, ksc, ks[b_idx, :, widx])
            vs[b_idx, :, widx] = torch.where(am2, vsc, vs[b_idx, :, widx])
            k_write, v_write = kq, vq
        else:
            k_write = k_new[:, :, 0].to(kc.dtype)
            v_write = v_new[:, :, 0].to(vc.dtype)
        kc[b_idx, :, widx] = torch.where(am3, k_write, kc[b_idx, :, widx])
        vc[b_idx, :, widx] = torch.where(am3, v_write, vc[b_idx, :, widx])
        pyramid = None
        if paged:
            pyramid, pb = ring_pyramid_update(
                PyramidState(cache["pyr_k"][i], cache["pyr_v"][i]),
                cache["page_blocks"], k_new[:, :, 0], v_new[:, :, 0], pos,
                cfg.attention.block_size, active=act)
            cache["pyr_k"][i].copy_(pyramid.k_sum)
            cache["pyr_v"][i].copy_(pyramid.v_sum)
            cache["page_blocks"].copy_(pb)
        o = decode_attention(q, kc, vc, lengths, cfg.attn_spec,
                             pyramid=pyramid,
                             page_blocks=cache.get("page_blocks"),
                             k_scale=ks, v_scale=vs)
        x = _residual_attention(x, o, p, cfg)
    x = L.apply_norm(x, params["ln_f"], cfg)
    logits = L.unembed(x, params["embed"], cfg)[:, 0]
    cache["lengths"].copy_(lengths)
    return logits, cache
