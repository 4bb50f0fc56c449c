"""Transformer families (dense and MoE decoders, the hubert encoder, the
internvl VLM): training forward and loss, serving cache, whole-prompt and
chunked prefill, decode.

Port of ``repro/models/transformer.py`` (DESIGN.md §9): the input
embedding of each family (``_input_embed``: tokens; hubert's projected
audio frames with masked positions replaced by ``mask_embed`` and learned
positions added; internvl's projected vision patches placed before the
text), the full-sequence ``forward`` / ``loss_fn`` that training runs (the
layers are a list here, so the reference's ``scan`` is a loop, each layer
under the config's remat policy; an MoE layer's routed FFN,
``models/moe.py``, adds its load-balance and router-z losses to the aux
total; hubert's NLL is the mean over its masked positions, internvl's
over the text after the patches), and the serving half —
``cache_specs`` (ring-paged layout, with or without the int8 KV cache,
and at ``levels >= 3`` the collapse-up hierarchy of ``core/hier.py``),
``layer_cache_kinds``, the whole-prompt ``prefill`` (full-sequence
attention over the prompt, then the cache written at positions [0, S)),
``prefill_chunk`` and ``decode_step``.

Unlike the reference, ``prefill``, ``prefill_chunk`` and ``decode_step``
update the cache tensors **in place** (and return the same dict): a slot
that is frozen for the call (``num_valid == 0``, ``active == False``) has
every row of its K/V, scales, pyramid sums, hierarchy tables and payloads,
page-table entries and length left bit-identical. In-place updates set the
order of work at H >= 3: the collapse plan reads the page table before the
call rewrites it, and each layer carries the evicted pages' sums up the
hierarchy before its pyramid drops them. An MoE layer routes every row of
a serving call — padded and frozen rows too — and so the capacity counts
them, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hier
from repro_torch.core.attention import (
    MRA_KINDS,
    chunk_attention,
    decode_attention,
    self_attention,
)
from repro_torch.core.mra_decode import (
    PyramidState,
    quantize_kv,
    ring_pyramid_update,
)
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh_utils

from . import layers as L
from .moe import moe_block
from .params import TensorSpec


def _ffn(x, p, cfg: ModelConfig):
    """The layer's FFN on its normed input: (out, aux losses dict)."""
    if "moe" in p:
        return moe_block(x, p["moe"], cfg)
    return L.mlp_block(x, p["mlp"], cfg), {}


def _layer_fwd(x, p, cfg: ModelConfig, key_mask):
    h = L.apply_norm(x, p["ln1"], cfg)
    x = x + L.attn_block(h, p["attn"], cfg, key_mask=key_mask)
    out, aux = _ffn(L.apply_norm(x, p["ln2"], cfg), p, cfg)
    return x + out, aux


def _input_embed(params, cfg: ModelConfig, batch):
    """The first layer's input x (B, S, d) in the activation dtype.

    dense / moe: the tokens' embedding. hubert: frames (B, S, Fd) projected
    by ``frontend.proj``, masked positions (``mask_positions`` (B, S) bool)
    replaced by ``frontend.mask_embed``, learned positions added. internvl:
    patches (B, P, Fd) projected, then the text tokens' embedding (S = P +
    S_text)."""
    adt = cfg.adt
    if cfg.family == "hubert":
        x = torch.einsum("bsf,fd->bsd", batch["frames"].to(adt),
                         params["frontend"]["proj"].to(adt))
        mask_emb = params["frontend"]["mask_embed"].to(adt)
        x = torch.where(batch["mask_positions"][..., None], mask_emb, x)
        if cfg.pos == "learned":
            x = x + params["embed"]["pos"][:x.shape[1]].to(adt)
        return x
    if cfg.family == "internvl":
        patches = torch.einsum("bpf,fd->bpd", batch["patches"].to(adt),
                               params["frontend"]["proj"].to(adt))
        text = L.embed(batch["tokens"], params["embed"], cfg)
        return torch.cat([patches, text], dim=1)
    return L.embed(batch["tokens"], params["embed"], cfg)


def _forward(params, cfg: ModelConfig, batch, key_mask):
    """``forward`` with the logits as ``unembed`` leaves them (the rank's
    vocab columns under a vocab-split mesh)."""
    x = _input_embed(params, cfg, batch)
    body = L.remat_wrap(_layer_fwd, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        x, aux = body(x, p, cfg, key_mask)
        for v in aux.values():
            aux_total = aux_total + v
    x = L.apply_norm(x, params["ln_f"], cfg)
    return L.unembed(x, params["embed"], cfg), aux_total


def forward(params, cfg: ModelConfig, batch, *, key_mask=None):
    """Full-sequence forward.

    batch: the family's (``_input_embed``): {"tokens": (B, S) int} for
    dense / moe, {"frames", "mask_positions"} for hubert, {"tokens",
    "patches"} for internvl; key_mask: optional (B, S) bool. Attention is
    causal unless the config says otherwise (hubert). Returns (logits (B,
    S, padded_vocab) in the activation dtype, aux loss: an fp32 scalar, the
    MoE layers' losses summed over layers in the reference's order; zero
    for the other families).

    Under an active mesh ``params`` are the rank's blocks
    (``shard_params``) and ``batch`` its rows (``batch_pspec``); the logits
    are the rank's rows over the whole vocab.
    """
    logits, aux_total = _forward(params, cfg, batch, key_mask)
    return L.gather_vocab(logits, cfg), aux_total


def loss_fn(params, cfg: ModelConfig, batch, *, key_mask=None):
    """Mean NLL of the targets: next tokens (dense / moe), the text after
    the ``num_patches`` patches (internvl), or the masked-unit targets at
    ``mask_positions`` only, sum / max(count, 1) (hubert). Returns
    (loss + aux, {"loss", "aux_loss", "nll"}).

    Under an active mesh the batch is the rank's rows and the loss its
    share: the mean of the ranks' losses over the data axes is the whole
    batch's (hubert's count of masked positions is summed over them)."""
    logits, aux = _forward(params, cfg, batch, key_mask)
    if cfg.family == "internvl":
        logits = logits[:, cfg.num_patches:]
    nll = L.lm_nll(logits, batch["targets"], cfg)
    if cfg.family == "hubert":
        w = batch["mask_positions"].to(torch.float32)  # predict only masked
        count = torch.sum(w)
        mesh = mesh_utils.get_mesh()
        dp = C.axis_size(mesh, "data")
        if dp > 1:
            count = C.all_reduce(count, mesh, "data") / dp
        loss = torch.sum(nll * w) / torch.clamp(count, min=1.0 / dp)
    else:
        loss = nll.mean()
    metrics = {"loss": loss, "aux_loss": aux, "nll": loss}
    return loss + aux, metrics


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The serving cache as TensorSpecs (per-layer lists, as the reference).

    k/v (B, Hkv, S, hd) at the activation dtype (int8 with per-token scales
    under ``kv_quant``); under the MRA kinds also the fp32 pyramid block
    sums (B, Hkv, nb, hd) per layer and the shared ring page table (B, nb)
    (physical page -> logical block, -1 = never written). At
    ``levels >= 3`` (MRA kinds) the hierarchy of ``core/hier.py``: per
    collapsed level l in [2, H) int8 means ``hier_k{l}``/``hier_v{l}``
    (B, Hkv, n, hd) and fp32 scales ``hier_ks{l}``/``hier_vs{l}``
    (B, Hkv, n) per layer, shared int32 tables ``hier_own{l}`` (B, n, fill
    -1) and ``hier_cnt{l}`` (B, n); fp32 tail sums ``tail_k``/``tail_v``
    (B, Hkv, hd) per layer and the shared int32 ``tail_cnt`` (B,), with
    n = ``hier_pages`` or nb.
    """
    hd, Hkv, Lx = cfg.hd, cfg.kv_heads, cfg.num_layers
    mra = cfg.attention.kind in MRA_KINDS
    quant = cfg.attention.kv_quant and mra
    bh = ("batch", "kv_heads")
    kv = TensorSpec((batch, Hkv, max_len, hd),
                    torch.int8 if quant else cfg.adt, "zeros",
                    axes=bh + ("kv_seq", None))
    c = {"k": [kv] * Lx, "v": [kv] * Lx,
         "lengths": TensorSpec((batch,), torch.int32, "zeros",
                               axes=("batch",))}
    if quant:
        sc = TensorSpec((batch, Hkv, max_len), torch.float32, "zeros",
                        axes=bh + ("kv_seq",))
        c["k_scale"] = [sc] * Lx
        c["v_scale"] = [sc] * Lx
    if mra:
        nb = max_len // cfg.attention.block_size
        pyr = TensorSpec((batch, Hkv, nb, hd), torch.float32, "zeros",
                         axes=bh + (None, None))
        c["pyr_k"] = [pyr] * Lx
        c["pyr_v"] = [pyr] * Lx
        c["page_blocks"] = TensorSpec((batch, nb), torch.int32, "fill", -1,
                                      axes=("batch", None))
        if cfg.attention.levels >= 3:
            n = cfg.attention.hier_pages or nb
            hmean = TensorSpec((batch, Hkv, n, hd), torch.int8, "zeros",
                               axes=bh + (None, None))
            hscale = TensorSpec((batch, Hkv, n), torch.float32, "zeros",
                                axes=bh + (None,))
            for lvl in range(2, cfg.attention.levels):
                c[f"hier_k{lvl}"] = [hmean] * Lx
                c[f"hier_v{lvl}"] = [hmean] * Lx
                c[f"hier_ks{lvl}"] = [hscale] * Lx
                c[f"hier_vs{lvl}"] = [hscale] * Lx
                c[f"hier_own{lvl}"] = TensorSpec((batch, n), torch.int32,
                                                 "fill", -1,
                                                 axes=("batch", None))
                c[f"hier_cnt{lvl}"] = TensorSpec((batch, n), torch.int32,
                                                 "zeros",
                                                 axes=("batch", None))
            tail = TensorSpec((batch, Hkv, hd), torch.float32, "zeros",
                              axes=bh + (None,))
            c["tail_k"] = [tail] * Lx
            c["tail_v"] = [tail] * Lx
            c["tail_cnt"] = TensorSpec((batch,), torch.int32, "zeros",
                                       axes=("batch",))
    return c


def layer_cache_kinds(cfg: ModelConfig):
    """Per-layer serving-cache kinds: ring-paged under MRA, plain KV else."""
    kind = "paged_kv" if cfg.attention.kind in MRA_KINDS else "kv"
    return [kind] * cfg.num_layers


def _residual_attention(x, o, p, cfg: ModelConfig, tp):
    """The layer after its attention: output projection, residual, FFN
    (a serving call drops the MoE aux losses)."""
    x = x + L.attn_output(o, p["attn"], cfg, tp)
    out, _ = _ffn(L.apply_norm(x, p["ln2"], cfg), p, cfg)
    return x + out


def _project(x, p, cfg: ModelConfig, positions):
    """A serving layer's q / k / v (the rank's heads) and its attention
    weights as ``_residual_attention`` takes them."""
    tp = L.tp_layout(cfg)
    pa = L.attn_params(p["attn"], cfg, tp)
    h = L.attn_input(L.apply_norm(x, p["ln1"], cfg), tp)
    q, k, v = L.qkv_project(h, pa, cfg, positions)
    return q, k, v, dict(p, attn=pa), tp


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, cache):
    """Run a whole prompt, fill the cache, return (last logits, cache).

    batch: the family's (``_input_embed``), every slot S positions from 0:
    {"tokens": (B, S) int}, or for internvl {"tokens": (B, S_text),
    "patches": (B, P, Fd)} with S = P + S_text.
    Attention is the full-sequence kind of the config over the prompt
    (MRA-2: the block-sparse kernels on a card). The cache is written in
    place at positions [0, S): K/V (int8 codes and scales when the cache
    has scales), and under the MRA kinds the fp32 pyramid block sums of the
    S // b written pages, their page-table entries; ``lengths`` becomes S.
    The prompt must fit the cache window, and under the MRA kinds be a
    multiple of the block size (raises ValueError otherwise). Returns
    logits (B, padded_vocab) at position S - 1.

    Under an active mesh (here and in ``prefill_chunk`` / ``decode_step``)
    ``params``, ``cache`` and the per-slot inputs are the rank's blocks
    (the cache's ``rows`` cuts them), and the logits come back over the
    whole vocab for the rank's slots (the cache's ``whole`` gathers them
    over every slot).
    """
    x = _input_embed(params, cfg, batch)
    B, S, _ = x.shape
    S_phys = cache["k"][0].shape[2]
    bs = cfg.attention.block_size
    pyramid = "pyr_k" in cache
    if S > S_phys:
        raise ValueError(f"prompt of {S} tokens exceeds the cache window of "
                         f"{S_phys}")
    if pyramid and S % bs:
        raise ValueError(f"prompt of {S} tokens is not a multiple of the "
                         f"block size {bs} the pyramid sums need")
    dev = x.device
    positions = torch.arange(S, device=dev)
    hd = cfg.hd
    for i, p in enumerate(params["layers"]):
        q, k, v, p, tp = _project(x, p, cfg, positions)
        Hkv = k.shape[1]
        ke, ve = L.expand_kv_slots(k, v, cfg)
        o = self_attention(q, ke, ve, cfg.attn_spec, causal=cfg.causal)
        x = _residual_attention(x, o, p, cfg, tp)
        if "k_scale" in cache:  # int8 KV cache
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            cache["k_scale"][i][:, :, :S] = ksc
            cache["v_scale"][i][:, :, :S] = vsc
            k_write, v_write = kq, vq
        else:
            k_write, v_write = k, v
        cache["k"][i][:, :, :S] = k_write.to(cache["k"][i].dtype)
        cache["v"][i][:, :, :S] = v_write.to(cache["v"][i].dtype)
        if pyramid:
            nw = S // bs
            cache["pyr_k"][i][:, :, :nw] = k.reshape(B, Hkv, nw, bs, hd).sum(
                3, dtype=torch.float32)
            cache["pyr_v"][i][:, :, :nw] = v.reshape(B, Hkv, nw, bs, hd).sum(
                3, dtype=torch.float32)
    if "page_blocks" in cache:
        pb = cache["page_blocks"]
        pages = torch.arange(pb.shape[1], dtype=pb.dtype, device=dev)
        pb.copy_(torch.where(pages < S // bs, pages, pb))
    cache["lengths"].fill_(S)
    x = L.apply_norm(x, params["ln_f"], cfg)
    logits = L.unembed(x[:, -1:], params["embed"], cfg)
    return L.gather_vocab(logits[:, 0], cfg), cache


@torch.no_grad()
def prefill_chunk(params, cfg: ModelConfig, cache, tokens, num_valid, *,
                  all_logits: bool = False, collect_kv: bool = False):
    """Chunked batched prefill: C prompt tokens per slot, ragged lengths.

    Every prefilling slot advances by up to C tokens in one call: the
    chunk's K/V (and pyramid block sums) are written into the cache at the
    slot's offset, then the chunk's queries attend the updated cache. A
    chunk token that starts a new block recycles its ring page (drops the
    evicted block's sums first) — at H >= 3 after carrying them up the
    hierarchy, oldest evicted block first.

    Args:
      tokens: (B, C) int prompt chunk per slot (padding arbitrary).
      num_valid: (B,) count of real tokens per slot; 0 freezes the slot.
      all_logits: return logits at every chunk position, not just the last
        valid one (a speculative verify reads the target distribution after
        every draft).
      collect_kv: also return the chunk's per-layer fp32 K/V, (L, B, Hkv, C,
        D) each — the exact values the pyramid sums added, so a speculative
        rewind replays the kept prefix bit for bit even over an int8 cache.

    Returns:
      (logits (B, V) — or (B, C, V) with ``all_logits`` —, cache), the cache
      updated in place, with ``(chunk_k, chunk_v)`` appended when
      ``collect_kv``.
    """
    B, C = tokens.shape
    dev = tokens.device
    offsets = cache["lengths"]
    positions = offsets[:, None] + torch.arange(C, dtype=offsets.dtype,
                                                device=dev)  # (B, C)
    tv = torch.arange(C, device=dev) < num_valid[:, None]  # token validity
    lengths_new = offsets + num_valid.to(offsets.dtype)
    x = L.embed(tokens, params["embed"], cfg, positions=positions)
    paged = "page_blocks" in cache
    bs = cfg.attention.block_size
    b_idx = torch.arange(B, device=dev)
    b_idx2 = b_idx[:, None].expand(B, C)
    frozen = (num_valid == 0)[:, None, None, None]
    chunk_k, chunk_v = [], []

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
        hplans = []
        if hier.has_hier(cache):
            # H-level collapse, plan phase: the recycled pages' owners come
            # from the table before this call rewrites it; the shared
            # tables update once, every layer replays the plans below
            child = torch.full((B,), bs, dtype=torch.int32, device=dev)
            for blk_j, on_j in hier.eviction_schedule(pb, fresh, C // bs + 1):
                upd, plan = hier.cache_collapse_tables(cache, blk_j, child, on_j)
                hier.cache_store_tables(cache, upd)
                hplans.append((plan, blk_j % npages))
        pb.copy_(torch.where(touched, blk_new.to(pb.dtype), pb))

    for i, p in enumerate(params["layers"]):
        q, k_new, v_new, p, tp = _project(x, p, cfg, positions)
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
        if collect_kv:
            chunk_k.append(k_new.to(torch.float32))
            chunk_v.append(v_new.to(torch.float32))
        pyramid = None
        if paged:
            base_k, base_v = cache["pyr_k"][i], cache["pyr_v"][i]
            for plan, pg_j in hplans:  # value phase: before the sums drop
                hier.cache_store_layer(cache, i, hier.cache_collapse_layer(
                    cache, i, plan, base_k[b_idx, :, pg_j],
                    base_v[b_idx, :, pg_j]))
            f4 = fresh[:, None, :, None]
            pk = torch.where(f4, 0.0, base_k) + torch.einsum(
                "bcy,bhcd->bhyd", ind, k_new.to(torch.float32))
            pv = torch.where(f4, 0.0, base_v) + torch.einsum(
                "bcy,bhcd->bhyd", ind, v_new.to(torch.float32))
            base_k.copy_(torch.where(frozen, base_k, pk))
            base_v.copy_(torch.where(frozen, base_v, pv))
            pyramid = PyramidState(base_k, base_v,
                                   hier.cache_upper_view(cache, i))
        o = chunk_attention(
            q, kc, vc, lengths_new, positions, cfg.attn_spec, pyramid=pyramid,
            page_blocks=cache.get("page_blocks"), k_scale=ks, v_scale=vs)
        x = _residual_attention(x, o, p, cfg, tp)
    x = L.apply_norm(x, params["ln_f"], cfg)
    if all_logits:
        logits = L.unembed(x, params["embed"], cfg)  # (B, C, V)
    else:
        last = torch.clamp(num_valid.to(torch.long) - 1, 0, C - 1)
        x_last = x[torch.arange(B, device=dev), last]  # (B, d)
        logits = L.unembed(x_last[:, None], params["embed"], cfg)[:, 0]
    logits = L.gather_vocab(logits, cfg)
    cache["lengths"].copy_(lengths_new)
    if collect_kv:
        return logits, cache, (torch.stack(chunk_k), torch.stack(chunk_v))
    return logits, cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, tokens, active=None):
    """One decode step. tokens (B,) int -> (logits (B, V), cache).

    ``active`` (B,) bool restricts the step to a subset of slots: inactive
    slots' cache rows (KV, scales, pyramid, page table, length) stay
    bit-identical and their logits are garbage for the caller to ignore.
    ``None`` = all active. The write position wraps modulo the physical
    cache, so a stream past capacity recycles its oldest background page —
    at H >= 3 after collapsing its sums up the hierarchy. The cache is
    updated in place.
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
    bs = cfg.attention.block_size
    hplan = page_e = None
    if paged and hier.has_hier(cache):
        # H-level collapse, plan phase: a token that starts a block recycles
        # its page, whose owner carries up the hierarchy (floor division:
        # an idle slot's pos -1 maps to page nb - 1, and it is inactive)
        page_e = (pos // bs) % cache["page_blocks"].shape[1]
        old_owner = cache["page_blocks"][b_idx, page_e]
        evict = act & ((pos % bs) == 0) & (old_owner >= 0)
        upd, hplan = hier.cache_collapse_tables(
            cache, old_owner, torch.full((B,), bs, dtype=torch.int32,
                                         device=dev), evict)
        hier.cache_store_tables(cache, upd)
    for i, p in enumerate(params["layers"]):
        q, k_new, v_new, p, tp = _project(x, p, cfg, pos[:, None])
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
            if hplan is not None:  # value phase: before the page's sums drop
                hier.cache_store_layer(cache, i, hier.cache_collapse_layer(
                    cache, i, hplan, cache["pyr_k"][i][b_idx, :, page_e],
                    cache["pyr_v"][i][b_idx, :, page_e]))
            pyramid, pb = ring_pyramid_update(
                PyramidState(cache["pyr_k"][i], cache["pyr_v"][i]),
                cache["page_blocks"], k_new[:, :, 0], v_new[:, :, 0], pos,
                bs, active=act)
            cache["pyr_k"][i].copy_(pyramid.k_sum)
            cache["pyr_v"][i].copy_(pyramid.v_sum)
            cache["page_blocks"].copy_(pb)
            pyramid = pyramid._replace(upper=hier.cache_upper_view(cache, i))
        o = decode_attention(q, kc, vc, lengths, cfg.attn_spec,
                             pyramid=pyramid,
                             page_blocks=cache.get("page_blocks"),
                             k_scale=ks, v_scale=vs)
        x = _residual_attention(x, o, p, cfg, tp)
    x = L.apply_norm(x, params["ln_f"], cfg)
    logits = L.gather_vocab(L.unembed(x, params["embed"], cfg)[:, 0], cfg)
    cache["lengths"].copy_(lengths)
    return logits, cache
