"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local attention, 1:2.

Port of ``repro/models/recurrentgemma.py``. Temporal blocks repeat the
pattern (rglru, rglru, local): two gated-linear-recurrence blocks per
local-attention block. The RG-LRU diagonal recurrence

    a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

runs as a log-depth doubling scan (``_rglru_scan``): the reference uses
``jax.lax.associative_scan``, PyTorch has none, and a loop over the steps
would launch T small products forward and as many backward. The sums run
in another order than XLA's (equal within fp32 rounding, not bitwise).
Local attention is MQA (kv_heads=1) over a sliding window; the serving
cache keeps it as a ring of the last W = min(local_window, max_len) keys
(``serve/cache/window.py``), attended exactly in plain PyTorch
(``window_attention_core``, jnp in the reference too).

MRA applies to the local-attention layers only (DESIGN.md §5): with
``cfg.attention.kind`` "mra2" / "mra2_s" the training forward and the
whole-prompt ``prefill`` run them through ``mra2_attention``, whose
block-sparse kernels are built for this family's head dim 256 at b = 128.

Serving follows ``models/transformer.py``: ``prefill``, ``prefill_chunk``
and ``decode_step`` update the cache tensors **in place** and return the
same dict; a slot frozen for the call (``active`` False, ``num_valid`` 0)
keeps every row bit-identical, every write guarded by ``torch.where``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import MRA_KINDS, AttentionSpec, self_attention

from . import layers as L
from .params import TensorSpec, attn_specs, embed_specs, mlp_specs, norm_specs

_C = 8.0  # RG-LRU decay sharpness constant (Griffin paper)
_PATTERN = ("rglru", "rglru", "local")


def _pattern(cfg: ModelConfig):
    pat = cfg.block_pattern or _PATTERN
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


# --------------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------------- #
def _w(shape, dtype, axes, init="normal", scale=None):
    return TensorSpec(tuple(shape), dtype, init, 0.0, scale, tuple(axes))


def _rglru_specs(cfg: ModelConfig) -> dict:
    d, w, pdt = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.pdt
    return {
        "wx": _w((d, w), pdt, ("d_model", None)),
        "wy": _w((d, w), pdt, ("d_model", None)),
        "conv_w": _w((cfg.conv1d_width, w), pdt, (None, None), scale=0.1),
        "conv_b": _w((w,), pdt, (None,), "zeros"),
        "wa": _w((w, w), pdt, (None, None), scale=0.01),
        "ba": _w((w,), pdt, (None,), "zeros"),
        "wi": _w((w, w), pdt, (None, None), scale=0.01),
        "bi": _w((w,), pdt, (None,), "zeros"),
        "lam": _w((w,), pdt, (None,), "embed", scale=0.5),
        "wo": _w((w, d), pdt, (None, "d_model")),
    }


def layer_specs(cfg: ModelConfig, kind: str) -> dict:
    p = {"ln1": norm_specs(cfg), "ln2": norm_specs(cfg)}
    if kind == "local":
        p["attn"] = attn_specs(cfg)
    else:
        p["rglru"] = _rglru_specs(cfg)
    p["mlp"] = mlp_specs(cfg)
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree, the layers a list in pattern order
    (``params_from_jax`` unstacks the reference's ``groups`` / ``tail``)."""
    return {"embed": embed_specs(cfg), "ln_f": norm_specs(cfg),
            "layers": [layer_specs(cfg, k) for k in _pattern(cfg)]}


def _layers_iter(params, cfg: ModelConfig):
    """(kind, layer-params) pairs in order."""
    return list(zip(_pattern(cfg), params["layers"]))


# --------------------------------------------------------------------------- #
# RG-LRU block
# --------------------------------------------------------------------------- #
def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B,T,W); w (K,W). state (B,K-1,W) or None."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype)


def _rglru_scan(a, bx):
    """h_t = a_t h_{t-1} + bx_t over T, from h_{-1} = 0. a/bx (B,T,W).

    Returns (a_cum, h): a_cum_t = a_0 ··· a_t, the decay the state before
    the window reaches step t with (``prefill_chunk``: h = a_cum·h0 + h).
    A Hillis–Steele doubling scan: pass j combines each step with the one
    2^j before it, (A, H) <- (A_prev·A, A·H_prev + H), ceil(log2 T) passes
    of whole-tensor multiply-adds (12 at T = 4096)."""
    T = a.shape[1]
    A, H = a, bx
    d = 1
    while d < T:
        A_prev = F.pad(A[:, :-d], (0, 0, d, 0), value=1.0)
        H_prev = F.pad(H[:, :-d], (0, 0, d, 0))
        H = torch.addcmul(H, A, H_prev)
        A = A * A_prev
        d *= 2
    return A, H


def _decay(lam, gate):
    log_a = -_C * F.softplus(lam.float()) * gate
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with a = exp(log_a): expm1 keeps it accurate near a = 1
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, mult


def _gates(u, pr):
    """RG-LRU recurrence and input gates from the conv output, fp32."""
    uf = u.float()
    r = torch.sigmoid(uf @ pr["wa"].float() + pr["ba"].float())
    i = torch.sigmoid(uf @ pr["wi"].float() + pr["bi"].float())
    return uf, r, i


def _branches(h, pr):
    """The recurrence branch's input u and the gelu gate branch y."""
    adt = h.dtype
    u = torch.einsum("btd,dw->btw", h, pr["wx"].to(adt))
    y = F.gelu(torch.einsum("btd,dw->btw", h, pr["wy"].to(adt)),
               approximate="tanh")  # jax.nn.gelu's default
    return u, y


def rglru_block(x, p, cfg: ModelConfig):
    """x (B,T,d) -> (B,T,d)."""
    adt = x.dtype
    u, y = _branches(x, p)
    u = _causal_conv(u, p["conv_w"], p["conv_b"])
    uf, r, i = _gates(u, p)
    a, mult = _decay(p["lam"], r)
    _, h = _rglru_scan(a, mult * (i * uf))
    return torch.einsum("btw,wd->btd", h.to(adt) * y, p["wo"].to(adt))


# --------------------------------------------------------------------------- #
# full-sequence forward
# --------------------------------------------------------------------------- #
def _local_spec(cfg: ModelConfig) -> AttentionSpec:
    if cfg.attention.kind in MRA_KINDS:
        return cfg.attn_spec
    return dataclasses.replace(cfg.attn_spec, kind="local",
                               local_window=cfg.local_window)


def _layer_fwd(x, p, kind: str, cfg: ModelConfig, key_mask):
    h = L.apply_norm(x, p["ln1"], cfg)
    if kind == "local":
        x = x + L.attn_block(h, p["attn"], cfg, spec=_local_spec(cfg),
                             key_mask=key_mask)
    else:
        x = x + rglru_block(h, p["rglru"], cfg)
    h = L.apply_norm(x, p["ln2"], cfg)
    return x + L.mlp_block(h, p["mlp"], cfg)


def forward(params, cfg: ModelConfig, batch, *, key_mask=None):
    """Full-sequence forward: (logits (B, S, padded_vocab) in the activation
    dtype, a zero fp32 aux loss). Each layer runs under the config's remat
    policy."""
    x = L.embed(batch["tokens"], params["embed"], cfg)
    body = L.remat_wrap(_layer_fwd, cfg)
    for kind, p in _layers_iter(params, cfg):
        x = body(x, p, kind, cfg, key_mask)
    x = L.apply_norm(x, params["ln_f"], cfg)
    return (L.unembed(x, params["embed"], cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, cfg: ModelConfig, batch, *, key_mask=None):
    """Mean next-token NLL: (loss, {"loss", "nll"})."""
    logits, _ = forward(params, cfg, batch)
    loss = L.lm_nll(logits, batch["targets"], cfg).mean()
    return loss, {"loss": loss, "nll": loss}


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The local layers' K/V ring (n_attn, B, Hkv, W, hd) in the activation
    dtype with the absolute position of each entry ``kv_pos`` (n_attn, B,
    W; -1 = empty: zeros would alias an unwritten entry with a real
    position-0 key), the RG-LRU layers' fp32 state ``h`` (n_rec, B, w) and
    conv tail ``conv`` (n_rec, B, K-1, w), and ``lengths`` (B,); W =
    min(local_window, max_len). The slot axis is second in every layered
    leaf (the state backends' reset relies on it)."""
    kinds = _pattern(cfg)
    n_attn = sum(1 for k in kinds if k == "local")
    n_rec = len(kinds) - n_attn
    w = cfg.lru_width or cfg.d_model
    W = min(cfg.local_window, max_len)
    kv = (n_attn, batch, cfg.kv_heads, W, cfg.hd)
    kv_ax = (None, "batch", None, None, None)
    return {
        "k": TensorSpec(kv, cfg.adt, "zeros", axes=kv_ax),
        "v": TensorSpec(kv, cfg.adt, "zeros", axes=kv_ax),
        "kv_pos": TensorSpec((n_attn, batch, W), torch.int32, "fill", -1.0,
                             axes=(None, "batch", None)),
        "h": TensorSpec((n_rec, batch, w), torch.float32, "zeros",
                        axes=(None, "batch", None)),
        "conv": TensorSpec((n_rec, batch, cfg.conv1d_width - 1, w), cfg.adt,
                           "zeros", axes=(None, "batch", None, None)),
        "lengths": TensorSpec((batch,), torch.int32, "zeros",
                              axes=("batch",)),
    }


def layer_cache_kinds(cfg: ModelConfig):
    """Per-layer cache kinds (the cache protocol, DESIGN.md §12): the local
    layers' sliding-window ring, the RG-LRU layers' O(1) state, both in
    one ``HybridWindowCache`` tree."""
    return ["window" if k == "local" else "rglru" for k in _pattern(cfg)]


def window_attention_core(q, k_new, v_new, kc, vc, pos_c, positions, tv, *,
                          window: int, hd: int):
    """Exact sliding-window attention for a serving chunk over a ring cache.

    q (B,Hq,C,hd) and k_new/v_new (B,Hkv,C,hd) are the chunk's projections;
    kc/vc (B,Hkv,W,hd) + pos_c (B,W) are the ring *as of the chunk start*
    (-1 = empty entry); positions (B,C) absolute query positions; tv (B,C)
    lane validity. Query t attends ring entries in its window plus chunk
    keys s <= t — exactly the keys a token-by-token replay would see, so
    chunked prefill is causality-exact however the stream was chunked (the
    chunk's writes happen only after this attention). Decode is C == 1.
    """
    B, Hq, C, _ = q.shape
    Hkv, W = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, C, hd).float() * (1.0 / (hd ** 0.5))
    pq = positions[:, :, None]  # (B,C,1)
    sr = torch.einsum("bkgtd,bkwd->bkgtw", qf, kc.float())
    pr = pos_c[:, None, :]  # (B,1,W)
    ok_r = (pr >= 0) & (pr < pq) & (pr > pq - window)  # (B,C,W)
    sr = torch.where(ok_r[:, None, None], sr, -1e9)
    sc = torch.einsum("bkgtd,bksd->bkgts", qf, k_new.float())
    rel = pq - positions[:, None, :]  # (B,C,C) query pos - key pos
    ok_c = tv[:, None, :] & (rel >= 0) & (rel < window)
    sc = torch.where(ok_c[:, None, None], sc, -1e9)
    p = torch.softmax(torch.cat([sr, sc], dim=-1), dim=-1)
    o = (torch.einsum("bkgtw,bkwd->bkgtd", p[..., :W], vc.float())
         + torch.einsum("bkgts,bksd->bkgtd", p[..., W:], v_new.float()))
    return o.reshape(B, Hq, C, hd).to(q.dtype)


def _window_attention(q, k_new, v_new, kc, vc, pos_c, positions, tv,
                      cfg: ModelConfig):
    return window_attention_core(q, k_new, v_new, kc, vc, pos_c, positions,
                                 tv, window=cfg.local_window, hd=cfg.hd)


def _ring_write(cache, ia, k, v, positions, tv):
    """Write the chunk's valid lanes into layer ``ia``'s ring at pos % W.

    k/v (B,Hkv,C,hd), positions / tv (B,C). With C <= W the C lanes of a
    row land on distinct entries, so each lane rewrites its own entry: the
    new key where the lane is valid, the entry's old contents where it is
    not (no two writes meet, and the index_put is deterministic)."""
    kc, vc, pc = cache["k"][ia], cache["v"][ia], cache["kv_pos"][ia]
    W = kc.shape[2]
    rows = torch.arange(kc.shape[0], device=kc.device)[:, None]
    idx = torch.remainder(positions, W).long()  # (B,C)
    m4 = tv[:, :, None, None]
    kc[rows, :, idx] = torch.where(m4, k.transpose(1, 2).to(kc.dtype),
                                   kc[rows, :, idx])
    vc[rows, :, idx] = torch.where(m4, v.transpose(1, 2).to(vc.dtype),
                                   vc[rows, :, idx])
    pc[rows, idx] = torch.where(tv, positions.to(pc.dtype), pc[rows, idx])


def decode_step(params, cfg: ModelConfig, cache, tokens, active=None):
    """One serving decode step. tokens (B,) -> (logits (B, V), cache).

    ``active`` (B,) bool freezes inactive slots: every cache leaf of theirs
    stays bit-identical (``torch.where``-guarded writes, never arithmetic
    no-ops: -0.0 + 0.0 == +0.0 would flip a sign bit) and their logits are
    garbage for the caller to ignore. ``None`` = all active.
    """
    B = tokens.shape[0]
    dev = tokens.device
    act = (torch.ones((B,), dtype=torch.bool, device=dev) if active is None
           else active.to(torch.bool))
    pos_now = (cache["lengths"] + act.to(cache["lengths"].dtype) - 1).long()
    x = L.embed(tokens[:, None], params["embed"], cfg)  # (B,1,d)
    ia = ir = 0
    K = cfg.conv1d_width
    for kind, p in _layers_iter(params, cfg):
        h = L.apply_norm(x, p["ln1"], cfg)
        if kind == "local":
            q, k_new, v_new = L.qkv_project(h, p["attn"], cfg, pos_now[:, None])
            # attend before writing: the ring as of the step's start plus
            # the step's own key (a wrapping write cannot evict a needed
            # entry); -1 on a frozen empty slot lands in range, masked
            o = _window_attention(q, k_new, v_new, cache["k"][ia],
                                  cache["v"][ia], cache["kv_pos"][ia],
                                  pos_now[:, None], act[:, None], cfg)
            _ring_write(cache, ia, k_new, v_new, pos_now[:, None], act[:, None])
            x = x + torch.einsum("bhsk,hkd->bsd", o, p["attn"]["wo"].to(x.dtype))
            ia += 1
        else:
            pr = p["rglru"]
            adt = x.dtype
            u, y = _branches(h, pr)
            u, y = u[:, 0], y[:, 0]  # (B,w)
            conv_st = cache["conv"][ir]  # (B,K-1,w)
            xp = torch.cat([conv_st.to(adt), u[:, None]], dim=1)  # (B,K,w)
            cw = pr["conv_w"].to(adt)
            u = sum(xp[:, i] * cw[i] for i in range(K)) + pr["conv_b"].to(adt)
            conv_st.copy_(torch.where(act[:, None, None],
                                      xp[:, 1:].to(conv_st.dtype), conv_st))
            uf, r, i_g = _gates(u, pr)
            a, mult = _decay(pr["lam"], r)
            h0 = cache["h"][ir]
            hst = a * h0 + mult * (i_g * uf)
            h0.copy_(torch.where(act[:, None], hst, h0))
            x = x + torch.einsum("bw,wd->bd", hst.to(adt) * y,
                                 pr["wo"].to(adt))[:, None]
            ir += 1
        h = L.apply_norm(x, p["ln2"], cfg)
        x = x + L.mlp_block(h, p["mlp"], cfg)
    x = L.apply_norm(x, params["ln_f"], cfg)
    logits = L.unembed(x, params["embed"], cfg)[:, 0]
    cache["lengths"].add_(act.to(cache["lengths"].dtype))
    return logits, cache


def prefill(params, cfg: ModelConfig, batch, cache):
    """Whole-prompt prefill of every slot from position 0: the full-sequence
    layers (the local layers through ``self_attention``: exact, or MRA-2
    on the block-sparse forward kernel), then the last W positions of each
    local layer into its ring at pos % W (``kv_pos`` reset to -1 around
    them) and each RG-LRU layer's final state and raw conv tail. batch
    {"tokens": (B, S)}. Returns (last logits (B, V), cache)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    dev = tokens.device
    x = L.embed(tokens, params["embed"], cfg)
    ia = ir = 0
    W = cache["k"].shape[3]
    Kw = cfg.conv1d_width
    positions = torch.arange(S, device=dev)
    take = min(W, S)
    last_pos = torch.arange(S - take, S, device=dev)
    slots = torch.remainder(last_pos, W)
    for kind, p in _layers_iter(params, cfg):
        h = L.apply_norm(x, p["ln1"], cfg)
        if kind == "local":
            q, k, v = L.qkv_project(h, p["attn"], cfg, positions)
            o = self_attention(q, k, v, _local_spec(cfg), causal=True)
            x = x + torch.einsum("bhsk,hkd->bsd", o, p["attn"]["wo"].to(x.dtype))
            cache["k"][ia][:, :, slots] = k[:, :, S - take:].to(cache["k"].dtype)
            cache["v"][ia][:, :, slots] = v[:, :, S - take:].to(cache["v"].dtype)
            pc = cache["kv_pos"][ia]
            pc.fill_(-1)
            pc[:, slots] = last_pos.to(pc.dtype)
            ia += 1
        else:
            pr = p["rglru"]
            adt = x.dtype
            u, y = _branches(h, pr)
            uf, r, i_g = _gates(_causal_conv(u, pr["conv_w"], pr["conv_b"]), pr)
            a, mult = _decay(pr["lam"], r)
            _, hseq = _rglru_scan(a, mult * (i_g * uf))
            cache["h"][ir].copy_(hseq[:, -1])
            cache["conv"][ir].copy_(u[:, S - (Kw - 1):].to(cache["conv"].dtype))
            x = x + torch.einsum("btw,wd->btd", hseq.to(adt) * y,
                                 pr["wo"].to(adt))
            ir += 1
        h = L.apply_norm(x, p["ln2"], cfg)
        x = x + L.mlp_block(h, p["mlp"], cfg)
    x = L.apply_norm(x, params["ln_f"], cfg)
    logits = L.unembed(x[:, -1:], params["embed"], cfg)
    cache["lengths"].fill_(S)
    return logits[:, 0], cache


def prefill_chunk(params, cfg: ModelConfig, cache, tokens, num_valid, *,
                  all_logits=False, collect_kv=False):
    """Ragged chunked prefill: per-slot ``num_valid`` tokens of (B,C) land in
    the serving cache in one dispatch (DESIGN.md §12).

    Invalid lanes are inert: the local layers rewrite their ring entries
    with what they held (``_ring_write``), the RG-LRU layers carry the state
    through with decay 1 / input 0 lanes and ``where``-guarded state
    writes, so a slot fed 0 tokens stays bit-identical. The engine clamps C
    to the window (``HybridWindowCache.chunk_cap``) so a chunk's lanes land
    on distinct ring entries.

    Returns (logits, cache): logits at each slot's last valid position, or
    (B, C, V) at every chunk position with ``all_logits``. ``collect_kv``
    (the speculative verify's K/V) raises: the window cache has no pyramid
    to draft from.
    """
    if collect_kv:
        raise NotImplementedError(
            "speculative drafting needs the MRA paged-KV cache; the hybrid "
            "window cache does not collect per-chunk K/V")
    B, C = tokens.shape
    dev = tokens.device
    nv = num_valid.to(torch.int32)
    positions = (cache["lengths"][:, None].long()
                 + torch.arange(C, device=dev)[None, :])  # (B,C)
    tv = torch.arange(C, device=dev)[None, :] < nv[:, None]  # lane validity
    gate = nv > 0
    last = torch.clamp(nv - 1, 0, C - 1).long()
    rows = torch.arange(B, device=dev)
    x = L.embed(tokens, params["embed"], cfg)
    ia = ir = 0
    Kw = cfg.conv1d_width
    for kind, p in _layers_iter(params, cfg):
        h = L.apply_norm(x, p["ln1"], cfg)
        if kind == "local":
            q, k, v = L.qkv_project(h, p["attn"], cfg, positions)
            o = _window_attention(q, k, v, cache["k"][ia], cache["v"][ia],
                                  cache["kv_pos"][ia], positions, tv, cfg)
            x = x + torch.einsum("bhsk,hkd->bsd", o, p["attn"]["wo"].to(x.dtype))
            _ring_write(cache, ia, k, v, positions, tv)
            ia += 1
        else:
            pr = p["rglru"]
            adt = x.dtype
            u, y = _branches(h, pr)
            conv_st = cache["conv"][ir]  # (B,Kw-1,w)
            u_conv = _causal_conv(u, pr["conv_w"], pr["conv_b"], state=conv_st)
            # next conv state: the last Kw-1 valid raw inputs, counting the
            # carried state — row layout [state | u], the valid run ends at
            # Kw-1+nv, so gather [nv, nv+Kw-1) (the old state when nv = 0)
            xfull = torch.cat([conv_st.to(adt), u], dim=1)
            cidx = (nv[:, None] + torch.arange(Kw - 1, device=dev)[None, :]).long()
            new_conv = torch.gather(
                xfull, 1, cidx[:, :, None].expand(-1, -1, xfull.shape[2]))
            conv_st.copy_(torch.where(gate[:, None, None],
                                      new_conv.to(conv_st.dtype), conv_st))
            uf, r, i_g = _gates(u_conv, pr)
            a, mult = _decay(pr["lam"], r)
            # invalid lanes: decay exactly 1, input exactly 0 — the carried
            # state rides through the scan untouched
            m3 = tv[:, :, None]
            acum, h_scan = _rglru_scan(torch.where(m3, a, 1.0),
                                       torch.where(m3, mult * (i_g * uf), 0.0))
            h0 = cache["h"][ir]  # (B,w) fp32
            hseq = acum * h0[:, None] + h_scan  # (B,C,w)
            h0.copy_(torch.where(gate[:, None], hseq[rows, last], h0))
            x = x + torch.einsum("btw,wd->btd", hseq.to(adt) * y,
                                 pr["wo"].to(adt))
            ir += 1
        h = L.apply_norm(x, p["ln2"], cfg)
        x = x + L.mlp_block(h, p["mlp"], cfg)
    x = L.apply_norm(x, params["ln_f"], cfg)
    cache["lengths"].add_(nv)
    if all_logits:
        return L.unembed(x, params["embed"], cfg), cache
    return L.unembed(x[rows, last][:, None], params["embed"], cfg)[:, 0], cache
