"""Mixture-of-Experts FFN on one device (plain functions on tensors).

Port of ``repro/models/moe.py``, its single-device path (the reference's
``local`` body with no mesh): the sort + static-capacity-buffer dispatch,

  1. top-k routing per token, in fp32 whatever the activation dtype;
  2. assignments sorted by expert id (stable, so an expert keeps its
     assignments in flat ``t·k + j`` order); the position in the expert
     from an exclusive cumsum of the counts; assignments past the capacity
     dropped;
  3. dense per-expert products on the (E, capacity, d) buffers;
  4. the combine: each token's k gated rows summed in ascending expert
     order, in the activation dtype.

Every shape is static and nothing reads a value back to the host: counts
are a ``scatter_add_`` into a fixed (E + 1,) vector (not ``bincount``,
which syncs to size its output), dropped assignments go to a trash row and
column of the buffer that is sliced away, and the combine is a gather and
a fixed-order sum (no ``index_add_``, whose CUDA atomics would make reruns
differ in the last bit).

Under an active mesh with a "model" axis (the reference's three
``shard_map`` bodies, each rank holding its weight blocks; capacity from
the rank's own token count, as there):

  * expert-parallel (``E % |model| == 0``): the tokens replicated over
    "model", each rank runs its experts [e0, e0 + E / |model|) and the
    partial outputs are summed over "model";
  * the TP fallback (experts do not divide): every rank runs every expert
    on its slice of the expert d_ff, and the outputs are summed (when
    neither divides, every rank runs the whole layer);
  * ``moe_dispatch="a2a"`` (experts divide, ``S % |model| == 0``): each
    rank routes its sequence shard, the (E, C, d) buffer goes to the
    expert owners and back in two all-to-alls, and the shards are
    gathered; a decode step (S = 1) falls back to the expert-parallel sum.

The router runs replicated; its gates enter the split work through
``copy_to``. The aux losses are averaged over the data axes (and over
"model" under a2a, where each rank routed other tokens).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh_utils

from .params import TensorSpec


def moe_specs(cfg: ModelConfig) -> dict:
    """router (d, E), wi / wg (E, d, f), wo (E, f, d); the router is drawn
    at std 0.02, the experts at fan-in std (the reference's init)."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
    pdt = cfg.pdt
    up = ("experts", "d_model", "expert_ff")
    return {"router": TensorSpec((d, E), pdt, "normal", scale=0.02,
                                 axes=("d_model", None)),
            "wi": TensorSpec((E, d, f), pdt, axes=up),
            "wg": TensorSpec((E, d, f), pdt, axes=up),
            "wo": TensorSpec((E, f, d), pdt,
                             axes=("experts", "expert_ff", "d_model"))}


def capacity(T: int, spec: MoESpec) -> int:
    """Buffer rows per expert for T tokens (the reference's formula)."""
    return max(int(T * spec.top_k * spec.capacity_factor / spec.num_experts
                   + 1), 4)


def _route(x, wr, spec: MoESpec):
    """x (T, d) -> gates (T, k) fp32, idx (T, k) int64, aux losses.

    The top k come from a stable descending sort, so equal probabilities
    keep the lowest expert index first (``jax.lax.top_k``'s order)."""
    logits = x.to(torch.float32) @ wr.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[:, :spec.top_k]
    idx = top.indices[:, :spec.top_k]
    gates = gates / gates.sum(-1, keepdim=True)
    E = logits.shape[-1]
    me = probs.mean(0)  # (E,)
    ce = F.one_hot(idx, E).to(torch.float32).sum(1).mean(0)
    aux = {"load_balance": E * torch.sum(me * ce) * spec.aux_loss_coef,
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)
           * spec.router_z_coef}
    return gates, idx, aux


def _dispatch(x, idx, *, e0: int, e_local: int, capacity: int):
    """Sort the assignments and fill the (e_local, capacity, d) buffers.

    Returns (buf, meta); meta = (order, e_scatter, s_scatter, keep, tok)
    carries the scatter coordinates for the combine, with dropped (and out
    of range) assignments at the out-of-bounds (e_local, capacity)."""
    T, d = x.shape
    k = idx.shape[-1]
    local_e = idx.reshape(-1) - e0
    in_range = (local_e >= 0) & (local_e < e_local)
    sort_key = torch.where(in_range, local_e, e_local)  # out of range last
    order = torch.argsort(sort_key, stable=True)
    se = sort_key[order]
    tok = order // k
    counts = torch.zeros(e_local + 1, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts  # exclusive; row e_local unused
    slot = torch.arange(se.shape[0], device=x.device) - starts[se]
    keep = (se < e_local) & (slot < capacity)
    e_scatter = torch.where(keep, se, e_local)
    s_scatter = torch.where(keep, slot, capacity)
    buf = x.new_zeros((e_local + 1, capacity + 1, d))  # + trash row, column
    buf[e_scatter, s_scatter] = x[tok]
    return buf[:e_local, :capacity], (order, e_scatter, s_scatter, keep, tok)


def _expert_ffn(buf, wi, wg, wo):
    """SwiGLU per expert: (E, C, d) -> (E, C, d) in the buffer's dtype."""
    adt = buf.dtype
    h = torch.einsum("ecd,edf->ecf", buf, wi.to(adt))
    g = torch.einsum("ecd,edf->ecf", buf, wg.to(adt))
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, wo.to(adt))


def _combine(y, meta, gates, T: int):
    """(T, d): each token's k expert rows times their gates (0 where the
    assignment was dropped), summed one row at a time in ascending expert
    order in y's dtype — the order in which the reference's scatter-add
    meets them (its updates are sorted by expert)."""
    order, e_scatter, s_scatter, keep, tok = meta
    adt = y.dtype
    k = gates.shape[-1]
    y_pad = F.pad(y, (0, 0, 0, 1, 0, 1))  # the trash reads as zeros
    y_tok = y_pad[e_scatter, s_scatter]  # (T·k, d), sorted order
    y_tok = y_tok * (gates.reshape(-1)[order] * keep).to(adt)[:, None]
    # each token's k rows at their sorted positions, ascending: by expert id
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    rows = y_tok[torch.sort(rank.reshape(T, k), dim=-1).values]  # (T, k, d)
    out = torch.zeros((T, y.shape[-1]), dtype=adt, device=y.device)
    for j in range(k):
        out = out + rows[:, j]
    return out


def _expert_compute(x, gates, idx, wi, wg, wo, *, e0: int, e_local: int,
                    capacity: int):
    """Dense-expert compute for experts [e0, e0 + e_local): (T, d) out."""
    buf, meta = _dispatch(x, idx, e0=e0, e_local=e_local, capacity=capacity)
    y = _expert_ffn(buf, wi, wg, wo)
    return _combine(y, meta, gates, x.shape[0])


def moe_block(x, p, cfg: ModelConfig):
    """x (B, S, d) -> ((B, S, d), aux losses dict).

    T = B·S counts every row, padded and inactive serving rows too: they
    route and take capacity as in the reference. Under a mesh, x is the
    rank's rows and ``p`` its weight blocks (module docstring)."""
    if cfg.moe_dispatch not in ("psum", "a2a"):
        raise ValueError(f"moe_dispatch={cfg.moe_dispatch!r}: expected "
                         "'psum' or 'a2a'")
    B, S, d = x.shape
    spec = cfg.moe
    E = spec.num_experts
    mesh = mesh_utils.get_mesh()
    ms = C.axis_size(mesh, "model")
    if ms > 1 and cfg.moe_dispatch == "a2a" and E % ms == 0 and S % ms == 0:
        return _a2a_block(x, p, cfg, mesh)
    T = B * S
    xt = x.reshape(T, d)
    gates, idx, aux = _route(xt, p["router"], spec)
    e_local = p["wi"].shape[0]  # E / |model| (expert-parallel) or E
    if ms == 1 or (e_local == E and p["wi"].shape[-1] == spec.d_ff_expert):
        out = _expert_compute(xt, gates, idx, p["wi"], p["wg"], p["wo"],
                              e0=0, e_local=E, capacity=capacity(T, spec))
        return out.reshape(B, S, d), _data_mean(aux, mesh)
    out = _expert_compute(C.copy_to(xt, mesh), C.copy_to(gates, mesh), idx,
                          p["wi"], p["wg"], p["wo"],
                          e0=mesh.index("model") * e_local
                          if e_local < E else 0,
                          e_local=e_local, capacity=capacity(T, spec))
    return C.reduce_from(out, mesh).reshape(B, S, d), _data_mean(aux, mesh)


def _data_mean(aux: dict, mesh) -> dict:
    """The aux losses averaged over the data axes (gradients pass as they
    are: the train step averages them over the same axes)."""
    if C.axis_size(mesh, "data") == 1:
        return aux
    return {k: C.mean_from(v, mesh, "data") for k, v in aux.items()}


def _a2a_block(x, p, cfg: ModelConfig, mesh):
    """The all-to-all dispatch: the rank's sequence shard routed, its
    (E, C, d) buffer exchanged with the expert owners and back."""
    B, S, d = x.shape
    spec = cfg.moe
    ms = mesh.shape["model"]
    xs = C.slice_to(x, mesh, "model", 1)  # (B, S / ms, d)
    T = B * (S // ms)
    xt = xs.reshape(T, d)
    gates, idx, aux = _route(xt, C.copy_to(p["router"], mesh), spec)
    buf, meta = _dispatch(xt, idx, e0=0, e_local=spec.num_experts,
                          capacity=capacity(T, spec))
    recv = C.exchange(buf, mesh, "model", 0, 1)  # (E / ms, ms * C, d)
    y = _expert_ffn(recv, p["wi"], p["wg"], p["wo"])
    back = C.exchange(y, mesh, "model", 1, 0)  # (E, C, d)
    out = _combine(back, meta, gates, T).reshape(xs.shape)
    # over "model" each rank routed other tokens: the mean's gradient
    # reaches each rank's router block at 1 / ms (copy_to sums them)
    aux = {k: C.reduce_from(v / ms, mesh) for k, v in aux.items()}
    return C.gather_from(out, mesh, "model", 1), _data_mean(aux, mesh)
