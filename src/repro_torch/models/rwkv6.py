"""RWKV6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
decay.

Port of ``repro/models/rwkv6.py``. Per layer and head, with state
S in R^{dh x dh}:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(w0 + lora(x~_t))) a data-dependent per-channel decay.

Training and prefill use the chunked-parallel form (``wkv_chunked``):
C x C products with cumulative-decay weights inside a chunk, and the state
carried across chunks, S_c = diag(D_c) S_{c-1} + M_c. The reference
carries it with ``jax.lax.associative_scan``; PyTorch has none, so here a
loop over the chunks carries it in sequence (the sums run in another
order: equal to the reference within fp32 rounding, not bitwise).
``wkv_scan`` is the token-by-token recurrence that validates it. MRA does
not apply (no attention matrix), as in the reference (DESIGN.md §5).

Serving keeps, per layer and slot, the wkv state and the token-shift
carries (``cache_specs``). As in ``models/transformer.py``, ``prefill``,
``prefill_chunk`` and ``decode_step`` update the cache tensors **in place**
and return the same dict; a slot frozen for the call (``active`` False,
``num_valid`` 0) keeps every row bit-identical. The state is fp32, the
carries in the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from . import layers as L
from .params import TensorSpec, embed_specs, norm_specs


def _decay_clamp(chunk: int) -> float:
    """Per-step log-decay floor that keeps the factored chunk form in fp32
    range: every cumulative exponent within a chunk stays above -80 (the
    reference's argument; a channel forgetting more than e^-kappa of its
    state in one step contributes below ~1e-35)."""
    return min(5.0, 80.0 / chunk)


# --------------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------------- #
def _w(shape, dtype, axes, init="normal", scale=None):
    return TensorSpec(tuple(shape), dtype, init, 0.0, scale, tuple(axes))


def layer_specs(cfg: ModelConfig) -> dict:
    d, dh, f, lora, pdt = (cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff,
                           cfg.decay_lora, cfg.pdt)
    H = d // dh
    hx = ("d_model", "heads", None)
    tm = {
        "mu": _w((5, d), pdt, (None, "d_model"), "embed"),
        "w0": _w((d,), pdt, ("d_model",), "embed"),
        "wA": _w((d, lora), pdt, ("d_model", None), scale=0.01),
        "wB": _w((lora, d), pdt, (None, "d_model"), scale=0.01),
        "wr": _w((d, H, dh), pdt, hx),
        "wk": _w((d, H, dh), pdt, hx),
        "wv": _w((d, H, dh), pdt, hx),
        "wg": _w((d, H, dh), pdt, hx),
        "u": _w((H, dh), pdt, ("heads", None), "embed"),
        "wo": _w((H, dh, d), pdt, ("heads", None, "d_model")),
        "gn_w": _w((H, dh), pdt, ("heads", None), "ones"),
        "gn_b": _w((H, dh), pdt, ("heads", None), "zeros"),
    }
    cm = {
        "mu_k": _w((d,), pdt, ("d_model",), "embed"),
        "mu_r": _w((d,), pdt, ("d_model",), "embed"),
        "wk": _w((d, f), pdt, ("d_model", "d_ff")),
        "wv": _w((f, d), pdt, ("d_ff", "d_model")),
        "wr": _w((d, d), pdt, ("d_model", None)),
    }
    return {"ln1": norm_specs(cfg), "tm": tm, "ln2": norm_specs(cfg),
            "cm": cm}


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree (the layers a list; ``params_from_jax`` unstacks
    the reference's ``scan_layers`` layout)."""
    return {"embed": embed_specs(cfg), "ln_f": norm_specs(cfg),
            "layers": [layer_specs(cfg) for _ in range(cfg.num_layers)]}


# --------------------------------------------------------------------------- #
# time mixing
# --------------------------------------------------------------------------- #
def _shift(x, x_prev=None):
    """Previous-token values. x (B,T,d); ``x_prev`` (B,d) is the stream's
    token before this window (zeros when the stream starts at t = 0)."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _heads(a, H: int, dh: int):
    """(B, T, d) -> (B, H, T, dh)."""
    return a.reshape(a.shape[0], a.shape[1], H, dh).transpose(1, 2)


def _tm_inputs(x, p, cfg: ModelConfig, x_prev=None):
    """r, k, v (fp32), g (activation dtype) and the log decay lw (fp32),
    each (B,H,T,dh)."""
    adt = x.dtype
    xs = _shift(x, x_prev)
    mu = p["mu"].to(adt)  # (5, d)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    r = torch.einsum("btd,dhk->bhtk", xr, p["wr"].to(adt))
    k = torch.einsum("btd,dhk->bhtk", xk, p["wk"].to(adt))
    v = torch.einsum("btd,dhk->bhtk", xv, p["wv"].to(adt))
    g = F.silu(torch.einsum("btd,dhk->bhtk", xg, p["wg"].to(adt)))
    dw = torch.einsum(
        "btl,ld->btd",
        torch.tanh(torch.einsum("btd,dl->btl", xw, p["wA"].to(adt))),
        p["wB"].to(adt))
    H, dh = p["u"].shape
    wlog = -torch.exp(_heads(p["w0"].float() + dw.float(), H, dh))
    wlog = torch.clamp(wlog, min=-_decay_clamp(cfg.rwkv_chunk))
    return r.float(), k.float(), v.float(), g, wlog


def wkv_chunked(r, k, v, lw, u, chunk: int, initial_state=None,
                return_state=False):
    """Chunked-parallel WKV. r/k/v/lw (B,H,T,dh); u (H,dh) -> y (B,H,T,dh).

    ``initial_state`` (B,H,dh,dh) carries S from a previous window (the
    engine's chunk-by-chunk prefill); ``return_state`` also returns the
    post-window state S_T. Lanes with lw == 0 and k == 0 leave the state
    unchanged, so ragged windows mask by zeroing those inputs.
    """
    B, H, T, dh = r.shape
    C = chunk
    if T % C:
        raise ValueError(f"length {T} is not a multiple of the chunk {C}")
    nC = T // C
    rc, kc, vc, lwc = (a.reshape(B, H, nC, C, dh) for a in (r, k, v, lw))

    Lc = torch.cumsum(lwc, dim=3)  # cumulative log decay including step t
    Ltot = Lc[:, :, :, -1]  # (B,H,nC,dh)
    Lprev = Lc - lwc  # before step t

    # inter-chunk state S_c = diag(exp(Ltot_c)) S_{c-1} + M_c, carried in
    # order; S_prev[c] is the state before chunk c
    kd = kc * torch.exp(Ltot[:, :, :, None, :] - Lc)
    M = torch.einsum("bhcti,bhctj->bhcij", kd, vc)  # (B,H,nC,dh,dh)
    D = torch.exp(Ltot)
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    prev = []
    # unbind, not indexing: the backward of one unbind is one stack, where
    # each index's backward would fill a zero tensor of M's whole size
    for Mc, Dc in zip(M.unbind(2), D.unbind(2)):
        prev.append(S)
        S = torch.addcmul(Mc, Dc[..., None], S)
    S_prev = torch.stack(prev, dim=2)

    # intra-chunk: A[t,s] = r_t . exp(Lprev_t - Lc_s) k_s (s < t), u bonus
    # on the diagonal; exponents bounded by the per-step clamp
    rq = rc * torch.exp(Lprev)
    ki = kc * torch.exp(-Lc)
    A = torch.einsum("bhcti,bhcsi->bhcts", rq, ki)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    A = torch.where(tri, A, 0.0)
    diag = torch.einsum("bhcti,hi,bhcti->bhct", rc, u.float(), kc)
    y = torch.einsum("bhcts,bhcsj->bhctj", A, vc) + diag[..., None] * vc
    y = y + torch.einsum("bhcti,bhcij->bhctj", rq, S_prev)
    y = y.reshape(B, H, T, dh)
    return (y, S) if return_state else y


def wkv_scan(r, k, v, lw, u):
    """The token-by-token recurrence (the reference's ``lax.scan``)."""
    B, H, T, dh = r.shape
    uf = u.float()[None, :, :, None]
    S = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    ys = []
    for rt, kt, vt, wt in zip(*(a.unbind(2) for a in (r, k, v, lw))):
        a = kt[..., :, None] * vt[..., None, :]  # (B,H,dh,dh)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, S + uf * a))
        S = torch.exp(wt)[..., None] * S + a
    return torch.stack(ys, dim=2)


def _group_norm(y, w, b, eps):
    """Per-head normalization. y (B,H,T,dh)."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return (yn * w.float()[None, :, None, :]
            + b.float()[None, :, None, :])


def _tm_out(y, g, p, cfg: ModelConfig, x):
    """Group norm, the gate and the output projection: (B, T, d)."""
    y = _group_norm(y, p["gn_w"], p["gn_b"], cfg.norm_eps) * g.float()
    return torch.einsum("bhtk,hkd->btd", y.to(x.dtype), p["wo"].to(x.dtype))


def time_mix(x, p, cfg: ModelConfig, *, use_scan: bool = False):
    r, k, v, g, lw = _tm_inputs(x, p, cfg)
    if use_scan:
        y = wkv_scan(r, k, v, lw, p["u"])
    else:
        y = wkv_chunked(r, k, v, lw, p["u"], cfg.rwkv_chunk)
    return _tm_out(y, g, p, cfg, x)


def channel_mix(x, p, cfg: ModelConfig, x_prev=None):
    adt = x.dtype
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * p["mu_k"].to(adt)
    xr = x + (xs - x) * p["mu_r"].to(adt)
    k = torch.square(F.relu(torch.einsum("btd,df->btf", xk, p["wk"].to(adt))))
    out = torch.einsum("btf,fd->btd", k, p["wv"].to(adt))
    return torch.sigmoid(torch.einsum("btd,de->bte", xr,
                                      p["wr"].to(adt))) * out


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #
def _layer_fwd(x, p, cfg: ModelConfig, use_scan: bool):
    x = x + time_mix(L.apply_norm(x, p["ln1"], cfg), p["tm"], cfg,
                     use_scan=use_scan)
    return x + channel_mix(L.apply_norm(x, p["ln2"], cfg), p["cm"], cfg)


def forward(params, cfg: ModelConfig, batch, *, use_scan: bool = False,
            key_mask=None):
    """Full-sequence forward: (logits (B, S, padded_vocab) in the activation
    dtype, a zero fp32 aux loss). Each layer runs under the config's remat
    policy; ``use_scan`` takes the token-by-token recurrence."""
    x = L.embed(batch["tokens"], params["embed"], cfg)
    body = L.remat_wrap(_layer_fwd, cfg)
    for p in params["layers"]:
        x = body(x, p, cfg, use_scan)
    x = L.apply_norm(x, params["ln_f"], cfg)
    return (L.unembed(x, params["embed"], cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, cfg: ModelConfig, batch, *, key_mask=None):
    """Mean next-token NLL: (loss, {"loss", "nll"})."""
    logits, _ = forward(params, cfg, batch)
    loss = L.lm_nll(logits, batch["targets"], cfg).mean()
    return loss, {"loss": loss, "nll": loss}


# --------------------------------------------------------------------------- #
# serving: recurrent state instead of a KV cache
# --------------------------------------------------------------------------- #
def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Per layer and slot: the fp32 wkv ``state`` (L, B, H, dh, dh) and the
    token-shift carries ``tm_x`` / ``cm_x`` (L, B, d) in the activation
    dtype (the previous token's normed input of each branch); ``lengths``
    (B,). The slot axis is second in every layered leaf (the state
    backends' reset relies on it). ``max_len`` sizes nothing: the state is
    O(1) in the stream length."""
    d, dh, Lx = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers
    H = d // dh
    return {
        "state": TensorSpec((Lx, batch, H, dh, dh), torch.float32, "zeros",
                            axes=(None, "batch", "heads", None, None)),
        "tm_x": TensorSpec((Lx, batch, d), cfg.adt, "zeros",
                           axes=(None, "batch", "d_model")),
        "cm_x": TensorSpec((Lx, batch, d), cfg.adt, "zeros",
                           axes=(None, "batch", "d_model")),
        "lengths": TensorSpec((batch,), torch.int32, "zeros",
                              axes=("batch",)),
    }


def layer_cache_kinds(cfg: ModelConfig):
    """Per-layer serving-cache kinds (the cache protocol, DESIGN.md §12)."""
    return ["wkv"] * cfg.num_layers


def decode_step(params, cfg: ModelConfig, cache, tokens, active=None):
    """One recurrent step. tokens (B,) -> (logits (B, V), cache).

    ``active`` (B,) bool restricts the step to a subset of slots: inactive
    slots' state, carries and length stay bit-identical and their logits
    are garbage for the caller to ignore. ``None`` = all active.
    """
    B = tokens.shape[0]
    dev = tokens.device
    act = (torch.ones((B,), dtype=torch.bool, device=dev) if active is None
           else active.to(torch.bool))
    a2, a4 = act[:, None], act[:, None, None, None]
    x = L.embed(tokens[:, None], params["embed"], cfg)[:, 0]  # (B, d)
    dh = cfg.rwkv_head_dim
    H = cfg.d_model // dh
    for i, p in enumerate(params["layers"]):
        tm, cm = p["tm"], p["cm"]
        # time mix, one step
        h = L.apply_norm(x[:, None], p["ln1"], cfg)[:, 0]
        adt = h.dtype
        xs = cache["tm_x"][i].to(adt)
        mu = tm["mu"].to(adt)
        xr, xk, xv, xw, xg = (h + (xs - h) * mu[j] for j in range(5))
        r = torch.einsum("bd,dhk->bhk", xr, tm["wr"].to(adt)).float()
        k = torch.einsum("bd,dhk->bhk", xk, tm["wk"].to(adt)).float()
        v = torch.einsum("bd,dhk->bhk", xv, tm["wv"].to(adt)).float()
        g = F.silu(torch.einsum("bd,dhk->bhk", xg, tm["wg"].to(adt)))
        dw = torch.einsum(
            "bl,ld->bd",
            torch.tanh(torch.einsum("bd,dl->bl", xw, tm["wA"].to(adt))),
            tm["wB"].to(adt))
        # the chunked form's per-step log-decay floor, so a decode
        # continuation stays consistent with chunk-prefilled state
        w = torch.exp(torch.clamp(
            -torch.exp((tm["w0"].float() + dw.float()).reshape(B, H, dh)),
            min=-_decay_clamp(cfg.rwkv_chunk)))
        S = cache["state"][i]  # (B,H,dh,dh)
        a = k[..., :, None] * v[..., None, :]
        y = torch.einsum("bhi,bhij->bhj", r,
                         S + tm["u"].float()[None, :, :, None] * a)
        S.copy_(torch.where(a4, w[..., :, None] * S + a, S))
        cache["tm_x"][i].copy_(torch.where(a2, h.to(cache["tm_x"].dtype),
                                           cache["tm_x"][i]))
        y = _group_norm(y[:, :, None], tm["gn_w"], tm["gn_b"],
                        cfg.norm_eps)[:, :, 0] * g.float()
        x = x + torch.einsum("bhk,hkd->bd", y.to(x.dtype), tm["wo"].to(x.dtype))
        # channel mix, one step
        h = L.apply_norm(x[:, None], p["ln2"], cfg)[:, 0]
        adt = h.dtype
        xs = cache["cm_x"][i].to(adt)
        xk2 = h + (xs - h) * cm["mu_k"].to(adt)
        xr2 = h + (xs - h) * cm["mu_r"].to(adt)
        kk = torch.square(F.relu(torch.einsum("bd,df->bf", xk2,
                                              cm["wk"].to(adt))))
        out = torch.einsum("bf,fd->bd", kk, cm["wv"].to(adt))
        x = x + torch.sigmoid(torch.einsum("bd,de->be", xr2,
                                           cm["wr"].to(adt))) * out
        cache["cm_x"][i].copy_(torch.where(a2, h.to(cache["cm_x"].dtype),
                                           cache["cm_x"][i]))
    x = L.apply_norm(x[:, None], params["ln_f"], cfg)
    logits = L.unembed(x, params["embed"], cfg)[:, 0]
    cache["lengths"].add_(act.to(cache["lengths"].dtype))
    return logits, cache


def prefill(params, cfg: ModelConfig, batch, cache):
    """Whole-prompt prefill of every slot from position 0: the chunked
    forward, then each layer's final state over the whole prompt,
    S = Σ_s diag(exp(clip(L_total − L_s, −85, 0))) k_sᵀ v_s, and the
    carries at the last position. batch {"tokens": (B, S)}, S a multiple
    of ``rwkv_chunk``. Returns (last logits (B, V), cache)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = L.embed(tokens, params["embed"], cfg)
    for i, p in enumerate(params["layers"]):
        h = L.apply_norm(x, p["ln1"], cfg)
        r, k, v, g, lw = _tm_inputs(h, p["tm"], cfg)
        y = wkv_chunked(r, k, v, lw, p["tm"]["u"], cfg.rwkv_chunk)
        Lc = torch.cumsum(lw, dim=2)
        kd = k * torch.exp(torch.clamp(Lc[:, :, -1:] - Lc, -85.0, 0.0))
        cache["state"][i].copy_(torch.einsum("bhti,bhtj->bhij", kd, v))
        cache["tm_x"][i].copy_(h[:, -1].to(cache["tm_x"].dtype))
        x = x + _tm_out(y, g, p["tm"], cfg, x)
        h = L.apply_norm(x, p["ln2"], cfg)
        x = x + channel_mix(h, p["cm"], cfg)
        cache["cm_x"][i].copy_(h[:, -1].to(cache["cm_x"].dtype))
    x = L.apply_norm(x, params["ln_f"], cfg)
    logits = L.unembed(x[:, -1:], params["embed"], cfg)
    cache["lengths"].fill_(S)
    return logits[:, 0], cache


def prefill_chunk(params, cfg: ModelConfig, cache, tokens, num_valid, *,
                  all_logits=False, collect_kv=False):
    """Chunked batched prefill: C prompt tokens per slot, ragged lengths.

    One dispatch advances every prefilling slot's wkv state by up to C
    prompt tokens through ``wkv_chunked`` (the state carried in through
    ``initial_state``). Lanes at or past a slot's ``num_valid`` contribute
    decay exp(0) = 1 and k = 0, and every state and carry write is gated
    on ``num_valid > 0``, so a slot with ``num_valid == 0`` keeps every row
    bit-identical.

    Returns (logits, cache): logits at each slot's last valid position, or
    (B, C, V) at every chunk position with ``all_logits``. ``collect_kv``
    (the speculative verify's K/V) has no meaning for a recurrent state and
    raises.
    """
    if collect_kv:
        raise NotImplementedError(
            "recurrent state has no K/V stream to collect; speculative "
            "verify needs the ring-paged cache (DESIGN.md §12)")
    B, C = tokens.shape
    rc = cfg.rwkv_chunk
    Cp = -(-C // rc) * rc  # wkv_chunked needs a whole number of chunks
    if Cp != C:
        tokens = F.pad(tokens, (0, Cp - C))
    dev = tokens.device
    nv = num_valid.to(torch.int32)
    tv = torch.arange(Cp, device=dev) < nv[:, None]  # (B, Cp) lane validity
    last = torch.clamp(nv - 1, 0, Cp - 1).long()
    rows = torch.arange(B, device=dev)
    gate = nv > 0
    g2, g4 = gate[:, None], gate[:, None, None, None]
    m4 = tv[:, None, :, None]
    x = L.embed(tokens, params["embed"], cfg)
    for i, p in enumerate(params["layers"]):
        h = L.apply_norm(x, p["ln1"], cfg)
        # the token shift crosses the chunk boundary through the carry
        r, k, v, g, lw = _tm_inputs(h, p["tm"], cfg, x_prev=cache["tm_x"][i])
        lw = torch.where(m4, lw, 0.0)
        k = torch.where(m4, k, 0.0)
        v = torch.where(m4, v, 0.0)
        y, S_T = wkv_chunked(r, k, v, lw, p["tm"]["u"], rc,
                             initial_state=cache["state"][i],
                             return_state=True)
        cache["state"][i].copy_(torch.where(g4, S_T, cache["state"][i]))
        cache["tm_x"][i].copy_(torch.where(
            g2, h[rows, last].to(cache["tm_x"].dtype), cache["tm_x"][i]))
        x = x + _tm_out(y, g, p["tm"], cfg, x)
        h = L.apply_norm(x, p["ln2"], cfg)
        x = x + channel_mix(h, p["cm"], cfg, x_prev=cache["cm_x"][i])
        cache["cm_x"][i].copy_(torch.where(
            g2, h[rows, last].to(cache["cm_x"].dtype), cache["cm_x"][i]))
    x = L.apply_norm(x, params["ln_f"], cfg)
    cache["lengths"].add_(nv)
    if all_logits:
        return L.unembed(x[:, :C], params["embed"], cfg), cache
    return L.unembed(x[rows, last][:, None], params["embed"], cfg)[:, 0], cache
