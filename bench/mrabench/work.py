"""The H100's peaks and the work the benchmark's readings count.

Peaks: NVIDIA H100 SXM5 80GB data sheet, dense rates without sparsity, at
the card's 700 W limit. A call's least time is the larger of its
operations over the bf16 tensor-core peak and its bytes over the HBM rate.

The counts are of the work the inputs need, whatever implements it: no
tile, split plan or padding of a kernel enters them, so a share of a
roofline or of the peak cannot pass 100% through a miscount.
"""
from __future__ import annotations

import torch

BF16_FLOP_PER_S = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


# --------------------------------------------------------------------------- #
# the serving kernel: one chunk / decode call
# --------------------------------------------------------------------------- #
def chunk_call(q_pos, counts, *, Hkv: int, G: int, D: int, b: int, m: int,
               elem: int) -> tuple:
    """(flops, bytes), float64 tensors on the inputs' device, of one
    call of the serving attention, from its
    query positions q_pos (B, C) and the page fill counts (B, nb), with
    no page evicted (each page then holds one block, in order).

    A slot's valid rows are those with 0 <= p < its length (the sum of
    its counts). A row at p attends min(p + 1, (m - 1)·b + p % b + 1)
    keys exactly (its own page up to p and m - 1 full earlier pages, or
    everything before it), scores p // b earlier pages coarsely and adds
    the background of those not attended. Bytes: each K and V page that
    some selection of the (slot, kv-head) must read, at least
    max(own pages of its rows, the largest single row's pages), read once;
    the filled pages' fp32 means and counts; fp32 queries and outputs.
    A slot's valid rows are consecutive positions, so its own pages are
    the span from the first row's to the last row's."""
    q_pos = q_pos.long()
    length = counts.sum(-1).long()                           # (B,)
    valid = (q_pos >= 0) & (q_pos < length[:, None])
    p = torch.where(valid, q_pos, 0)
    pairs = torch.minimum(p + 1, (m - 1) * b + p % b + 1)
    past = p // b
    bg = torch.clamp(past - (m - 1), min=0)
    vf = valid.to(torch.float64)
    rows = vf.sum()
    per_row = 4 * D * pairs + 2 * D * past + 2 * D * bg
    flops = Hkv * G * (per_row.to(torch.float64) * vf).sum()
    big = torch.iinfo(torch.long).max
    own_hi = torch.where(valid, p // b, -1).amax(-1)
    own_lo = torch.where(valid, p // b, big).amin(-1)
    n_own = torch.clamp(own_hi - own_lo + 1, min=0).to(torch.float64)
    row_pages = torch.where(valid, torch.clamp(past + 1, max=m), 0)
    union = torch.maximum(n_own, row_pages.amax(-1).to(torch.float64))
    filled = (counts > 0).to(torch.float64).sum()
    nbytes = (Hkv * union.sum() * 2 * b * D * elem
              + Hkv * filled * 2 * D * 4 + filled * 8
              + 2 * Hkv * G * rows * D * 4 + rows * 4)
    return flops, nbytes


# --------------------------------------------------------------------------- #
# the block-sparse training kernels: one call
# --------------------------------------------------------------------------- #
PRODUCTS = {"bsa_fwd": 2, "bsa_bwd_dq": 3, "bsa_bwd_dkv": 4}


def bsa_call(kernel: str, flags, *, BHG: int, BHKV: int, n: int, d: int,
             b: int, elem: int) -> tuple:
    """(flops as a float64 tensor, bytes) of one call over (BHG, m) pair
    flags (bit 0 valid,
    bit 1 causal diagonal): b² score entries a full pair, b(b+1)/2 a
    diagonal one, each entry ``PRODUCTS[kernel]`` products of d
    multiply-adds. Bytes: q, k, v and the key mask, one int32 a pair, the
    fp32 stabilizer floor (fwd) or mt, do and dr (backward), and the fp32
    outputs, each once."""
    f = flags.long()
    ok = (f & 1) == 1
    diag = ok & ((f & 2) == 2)
    full = ok & ~diag
    entries = (full.sum().double() * b * b
               + diag.sum().double() * b * (b + 1) / 2)
    flops = 2 * PRODUCTS[kernel] * entries * d
    nb = n // b
    qkv = (BHG + 2 * BHKV) * n * d * elem + BHKV * n * 4 + flags.numel() * 4
    if kernel == "bsa_fwd":
        io = BHG * nb * 4 + BHG * n * (d + 2) * 4
    elif kernel == "bsa_bwd_dq":
        io = BHG * n * (d + 2) * 4 + BHG * n * d * 4
    else:
        io = BHG * n * (d + 2) * 4 + 2 * BHKV * n * d * 4
    return flops, float(qkv + io)


# --------------------------------------------------------------------------- #
# model FLOPs
# --------------------------------------------------------------------------- #
def matmul_params_per_token(model: dict) -> float:
    """Multiply-adds a token's layers need, head excluded: projections,
    and the dense MLP or the router plus the top-k experts."""
    d, H, Hkv = model["d_model"], model["num_heads"], model["kv_heads"]
    hd = model.get("head_dim") or d // H
    attn = d * H * hd * 2 + d * Hkv * hd * 2
    moe = model.get("moe")
    if moe:
        ffn = d * moe["num_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
    else:
        ffn = 3 * d * model["d_ff"]
    return float(model["num_layers"] * (attn + ffn))


def head_flops(model: dict) -> float:
    return 2.0 * model["d_model"] * model["vocab"]


def serve_attention_flops(model: dict, p: int) -> float:
    """Attention operations of one served row at position p, all layers."""
    att = model["attention"]
    b, m = att["block_size"], att["decode_blocks"]
    D = model.get("head_dim") or model["d_model"] // model["num_heads"]
    pairs = min(p + 1, (m - 1) * b + p % b + 1)
    past = p // b
    bg = max(past - (m - 1), 0)
    per_head = 4 * D * pairs + 2 * D * past + 2 * D * bg
    return float(model["num_layers"] * model["num_heads"] * per_head)


def serve_request_flops(model: dict, prompt: int, new: int) -> float:
    """A served request's model operations: every prompt position and every
    fed-back token through the layers, the head for each sampled token."""
    fed = prompt + max(new - 1, 0)
    mm = 2.0 * matmul_params_per_token(model) * fed
    att = sum(serve_attention_flops(model, p) for p in range(fed))
    return mm + att + head_flops(model) * new


def train_sequence_flops(model: dict, n: int) -> float:
    """Forward operations of one training sequence of n positions (the
    budget's pairs exact, every allowed block pair scored coarsely and
    the rest as background); a step's model operations are three times
    this (forward and backward), recomputation not counted."""
    att = model["attention"]
    b, per_row = att["block_size"], att["blocks_per_row"]
    D = model.get("head_dim") or model["d_model"] // model["num_heads"]
    nb = n // b
    allowed = nb * (nb + 1) // 2
    m = min(per_row * nb, allowed)
    entries = nb * b * (b + 1) / 2 + (m - nb) * b * b
    per_head = 4 * D * entries + 2 * D * allowed + 2 * D * (allowed - m)
    attn = model["num_layers"] * model["num_heads"] * per_head
    return (2.0 * matmul_params_per_token(model) * n + attn
            + head_flops(model) * n)
