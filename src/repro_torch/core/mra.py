"""MRA-2 approximate self-attention (Zeng et al., ICML 2022) in PyTorch.

Port of ``repro/core/mra.py``: the finite sentinels shared by every
selection path, ``MraConfig``, the one-level pyramid helpers and the
full-sequence ``mra2_attention`` that training runs (coarse block scores,
budgeted top-k block selection with forced diagonals, the exact
high-resolution term, the coarse background and the two-level stabilizer),
with the exact ``full_attention`` oracle.

The high-resolution term has one route, the kernel contract
``kernels.block_sparse_attn.block_sparse_attention`` (reference lines
244-283): the hand-written CUDA kernels on a card, their plain PyTorch
versions on the CPU. The tensor's device decides; there is no
``use_kernel`` / ``kernel_bwd`` / ``interpret`` switch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

NEG_INF = -1e9  # finite "minus infinity": exp(NEG_INF - c) underflows to 0, no NaNs
FORCE_BONUS = 2e9  # added to coarse scores of blocks that must be selected


@dataclasses.dataclass(frozen=True)
class MraConfig:
    """Configuration of the MRA-2 approximation.

    Attributes:
      block_size: side length b of the blocks (= ring-cache page size).
      blocks_per_row: training budget as the average number of exact blocks
        per query-block row; the total is ``blocks_per_row * ceil(n / b)``.
      variant: "full" = MRA-2 (coarse background kept), "sparse" = MRA-2-s.
      causal: autoregressive mask (block-triangular selection grid, exact
        masking inside diagonal blocks).
      force_diagonal: always select the diagonal blocks (every query row
        keeps at least one exact block).
      softmax_scale: score scale; None -> 1/sqrt(head_dim).
      compute_dtype: dtype of the coarse scores and accumulation.
      kernel_mode: serving-kernel tile shape (kernels/chunk_attn.py) —
        "latency" (single-query tiles) | "throughput" (multi-query tiles) |
        "auto" (resolved per call from the chunk width).
      draft_level: background resolution of speculative drafts; only 1 is
        served until the speculative slice.
    """

    block_size: int = 32
    blocks_per_row: int = 4
    variant: str = "full"
    causal: bool = False
    force_diagonal: bool = True
    softmax_scale: Optional[float] = None
    compute_dtype: torch.dtype = torch.float32
    kernel_mode: str = "auto"
    draft_level: int = 1

    def budget(self, n: int) -> int:
        nb = -(-n // self.block_size)
        want = self.blocks_per_row * nb
        max_blocks = nb * (nb + 1) // 2 if self.causal else nb * nb
        return min(want, max_blocks)


def block_mean(x: torch.Tensor, block: int, *, dim: int = -2,
               dtype=None) -> torch.Tensor:
    """Mean-pool ``x`` along ``dim`` in non-overlapping windows of ``block``
    (the pyramid downsampling of paper eq. (7), one level); ``dtype`` is the
    accumulation dtype."""
    dim = dim % x.ndim
    n = x.shape[dim]
    if n % block:
        raise ValueError(f"length {n} not divisible by block {block}")
    shape = x.shape[:dim] + (n // block, block) + x.shape[dim + 1:]
    return x.reshape(shape).mean(dim=dim + 1, dtype=dtype)


def block_sum(x: torch.Tensor, block: int, *, dim: int = -2,
              dtype=None) -> torch.Tensor:
    dim = dim % x.ndim
    n = x.shape[dim]
    if n % block:
        raise ValueError(f"length {n} not divisible by block {block}")
    shape = x.shape[:dim] + (n // block, block) + x.shape[dim + 1:]
    return x.reshape(shape).sum(dim=dim + 1, dtype=dtype)


def _pad_to_multiple(x: torch.Tensor, block: int, dim: int):
    """Zero-pad (False-pad for bool) ``x`` along ``dim`` to a multiple of
    ``block``; returns (padded, original length)."""
    dim = dim % x.ndim
    n = x.shape[dim]
    pad = (-n) % block
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), n


def _block_grid_mask(nb: int, causal: bool, device=None) -> torch.Tensor:
    """(nb, nb) boolean mask of *allowed* blocks on the selection grid."""
    if not causal:
        return torch.ones((nb, nb), dtype=torch.bool, device=device)
    r = torch.arange(nb, device=device)
    return r[:, None] >= r[None, :]


def _fine_causal_mask(b: int, device=None) -> torch.Tensor:
    """(b, b) lower-triangular mask used inside diagonal blocks."""
    r = torch.arange(b, device=device)
    return r[:, None] >= r[None, :]


class BlockSelection(NamedTuple):
    """The coarse level and the selected block pairs of one call.

    coarse_m (B,Hkv,G,nb,nb) masked coarse scores; allowed broadcastable to
    it; kcount (B,nb) valid keys per block; v_ds (B,Hkv,nb,D) masked value
    means; x_idx / y_idx (B,Hkv,G,m) selected (query, key) block pairs in
    ``lax.top_k`` order; sel_valid (B,Hkv,G,m); bg the background support;
    c_bg (B,Hkv,G,nb) the background max (NEG_INF when empty or sparse).
    """

    coarse_m: torch.Tensor
    allowed: torch.Tensor
    kcount: torch.Tensor
    v_ds: torch.Tensor
    x_idx: torch.Tensor
    y_idx: torch.Tensor
    sel_valid: torch.Tensor
    bg: torch.Tensor
    c_bg: torch.Tensor


def select_blocks(q_g, k, v, key_mask, cfg: MraConfig, scale: float
                  ) -> BlockSelection:
    """Pyramid downsample, coarse scores and the budgeted top-k selection
    (reference mra.py:187-241) on block-padded inputs.

    q_g (B,Hkv,G,n,D); k/v (B,Hkv,n,D); key_mask (B,n) bool; n % b == 0.
    """
    B, Hkv, G, n, D = q_g.shape
    b = cfg.block_size
    nb = n // b
    m = cfg.budget(n)
    cdt = cfg.compute_dtype
    km = key_mask.to(cdt)
    kcount = block_sum(km[..., None], b, dim=-2)[..., 0]  # (B, nb)
    has_valid = kcount > 0

    # masked means in the input dtype, summed in the compute dtype, so padded
    # keys do not skew the coarse scores (reference :196-206)
    kmn = km.to(k.dtype)[:, None, :, None]
    denom = torch.clamp(kcount, min=1.0)[:, None, :, None]
    q_ds = block_mean(q_g, b, dim=-2, dtype=cdt)  # (B,Hkv,G,nb,D)
    k_ds = block_sum(k * kmn, b, dim=-2, dtype=cdt) / denom  # (B,Hkv,nb,D)
    v_ds = block_sum(v * kmn, b, dim=-2, dtype=cdt) / denom

    coarse = torch.einsum("bhgxd,bhyd->bhgxy", q_ds, k_ds) * scale
    allowed = (_block_grid_mask(nb, cfg.causal, q_g.device)[None, None, None]
               & has_valid[:, None, None, None, :])
    coarse_m = torch.where(allowed, coarse, NEG_INF)

    sel_scores = coarse_m.detach()
    if cfg.force_diagonal:  # fp32 addition, as the reference's (ties at 2e9)
        eye = torch.eye(nb, dtype=torch.bool, device=q_g.device)
        sel_scores = torch.where(eye, sel_scores + FORCE_BONUS, sel_scores)
    flat = sel_scores.reshape(B, Hkv, G, nb * nb)
    # jax.lax.top_k breaks ties to the lowest index: a stable descending sort
    # does the same (torch.topk promises no order among equal values)
    top_vals, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[..., :m], top_idx[..., :m]
    x_idx = torch.div(top_idx, nb, rounding_mode="floor")
    y_idx = top_idx % nb
    sel_valid = top_vals > NEG_INF * 0.5

    sel_grid = torch.zeros((B, Hkv, G, nb * nb), dtype=torch.bool,
                           device=q_g.device).scatter_(-1, top_idx, sel_valid)
    bg = allowed & ~sel_grid.reshape(B, Hkv, G, nb, nb)
    if cfg.variant == "full":
        c_bg = torch.where(bg, coarse_m, NEG_INF).amax(-1)  # (B,Hkv,G,nb)
    else:
        c_bg = torch.full((B, Hkv, G, nb), NEG_INF, dtype=cdt,
                          device=q_g.device)
    return BlockSelection(coarse_m, allowed, kcount, v_ds, x_idx, y_idx,
                          sel_valid, bg, c_bg)


def kernel_pairs(sel: BlockSelection, causal: bool):
    """The block-sparse kernel's pair inputs for a selection: the stabilizer
    floor c (BHG, nb) fp32 and x_idx / y_idx / flags (BHG, m) int32 (flags
    bit0: pair valid; bit1: causal triangle on a diagonal block)."""
    B, Hkv, G, m = sel.x_idx.shape
    BHG = B * Hkv * G
    flags = sel.sel_valid.to(torch.int32)
    if causal:
        flags = flags | (2 * (sel.x_idx == sel.y_idx)).to(torch.int32)
    c_floor = torch.clamp(sel.c_bg, min=NEG_INF * 0.5)  # keep exp args finite
    return (c_floor.reshape(BHG, -1).to(torch.float32),
            sel.x_idx.reshape(BHG, m).to(torch.int32),
            sel.y_idx.reshape(BHG, m).to(torch.int32),
            flags.reshape(BHG, m))


def mra2_attention(q, k, v, cfg: MraConfig, *, key_mask=None):
    """MRA-2 attention.

    Args:
      q: (B, Hq, N, D) queries.
      k: (B, Hkv, N, D) keys; Hq must be a multiple of Hkv (GQA).
      v: (B, Hkv, N, D) values.
      cfg: approximation config.
      key_mask: optional (B, N) boolean validity of keys (True = valid).

    Returns:
      (B, Hq, N, D) attention output in q.dtype.
    """
    # imported here: the kernel module imports this one's sentinels
    from repro_torch.kernels.block_sparse_attn import block_sparse_attention

    orig_dtype = q.dtype
    B, Hq, N, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    b = cfg.block_size
    scale = cfg.softmax_scale if cfg.softmax_scale is not None else 1.0 / D**0.5
    cdt = cfg.compute_dtype

    q, _ = _pad_to_multiple(q, b, 2)
    k, _ = _pad_to_multiple(k, b, 2)
    v, _ = _pad_to_multiple(v, b, 2)
    n = q.shape[2]
    nb = n // b
    if key_mask is None:
        key_mask = (torch.arange(n, device=q.device) < N)[None].expand(B, n)
    else:
        key_mask, _ = _pad_to_multiple(key_mask.to(torch.bool), b, 1)

    q_g = q.reshape(B, Hkv, G, n, D)
    sel = select_blocks(q_g, k, v, key_mask, cfg, scale)
    c_bg = sel.c_bg

    # ---- high-resolution term: the block-sparse kernel contract ------------
    # The kernel raises the c_bg floor to the exact per-token score max
    # online and emits it as mt — the same two-level stabilizer as the
    # reference's jnp route.
    BHG = B * Hkv * G
    c_floor, x_idx, y_idx, flags = kernel_pairs(sel, cfg.causal)
    km_kv = key_mask[:, None].expand(B, Hkv, n).reshape(B * Hkv, n)
    out_f, rs_f, mt_f = block_sparse_attention(
        q_g.reshape(BHG, n, D), k.reshape(B * Hkv, n, D),
        v.reshape(B * Hkv, n, D), c_floor, x_idx, y_idx, flags,
        km_kv.to(torch.int32), scale=scale, block_size=b)
    out_hr = out_f.reshape(B, Hkv, G, nb, b, D)
    rs_hr = rs_f.reshape(B, Hkv, G, nb, b)
    mt = mt_f.detach().reshape(B, Hkv, G, nb, b)
    # adj = exp(c_bg - c_tok) rescales the block-stabilized background onto
    # the per-token stabilizer (the min guards c_bg = NEG_INF against the
    # c_floor clamp)
    zero = torch.zeros((), dtype=mt.dtype, device=mt.device)
    adj = torch.exp(torch.minimum(c_bg[..., None] - mt, zero)).to(cdt)

    # ---- low-resolution background (Alg. 2 coarse level) -------------------
    if cfg.variant == "full":
        c_safe = torch.clamp(c_bg, min=NEG_INF * 0.5)[..., None]
        # clamp at 0: exact on the background support (coarse_m <= c_bg
        # there) and keeps the off-support exp finite
        a_lr = torch.where(sel.bg, torch.exp(torch.minimum(
            sel.coarse_m - c_safe, zero.to(cdt))), 0.0)
        w_lr = a_lr * sel.kcount[:, None, None, None, :]
        out_lr = torch.einsum("bhgxy,bhyd->bhgxd", w_lr, sel.v_ds)
        rs_lr = w_lr.sum(-1)
        out_hr = out_hr + adj[..., None] * out_lr[..., None, :]
        rs_hr = rs_hr + adj * rs_lr[..., None]

    # guarded normalization: never let a ~0 denominator explode gradients
    alive = rs_hr > 0
    out = (torch.where(alive[..., None], out_hr, 0.0)
           / torch.where(alive, rs_hr, 1.0)[..., None])
    out = out.reshape(B, Hq, n, D)[:, :, :N]
    return out.to(orig_dtype)


def full_attention(q, k, v, *, causal: bool = False,
                   softmax_scale: Optional[float] = None, key_mask=None,
                   compute_dtype=torch.float32):
    """Exact softmax attention oracle (GQA aware). O(n^2)."""
    B, Hq, N, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / D**0.5
    qg = q.reshape(B, Hkv, G, N, D).to(compute_dtype)
    s = torch.einsum("bhgid,bhjd->bhgij", qg, k.to(compute_dtype)) * scale
    if causal:
        s = torch.where(_fine_causal_mask(N, q.device)[None, None, None], s,
                        NEG_INF)
    if key_mask is not None:
        s = torch.where(key_mask.to(torch.bool)[:, None, None, None, :], s,
                        NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgij,bhjd->bhgid", p, v.to(compute_dtype))
    return out.reshape(B, Hq, N, D).to(q.dtype)
