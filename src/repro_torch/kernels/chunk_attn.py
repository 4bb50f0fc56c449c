"""Chunk/decode MRA-2 attention: the CUDA serving kernel and its plain twin.

Port of ``repro/kernels/chunk_attn.py`` (DESIGN.md §11). Everything after
the shared page statistics (``core.mra_decode.ChunkPrelude``) — coarse page
scoring, the causal block mask, own-block force selection, top-m selection,
the gathered exact term, the coarse pyramid background and normalization —
is one function with two implementations:

  * ``csrc/chunk_attn.cu`` — a hand-written CUDA C++ kernel for Hopper
    (``sm_90a``), launched by ``chunk_attention_kernel`` for tensors on the
    card. One thread block owns one (batch·kv-head, query-tile) output tile;
    the note at the top of the source says what bounds it.
  * ``chunk_attention_ref`` — the plain PyTorch version of the reference's
    jnp route (``_select_pages`` + the tail of ``mra2_chunk_attention``),
    which the wrapper takes for tensors on the CPU and which ``chip_smoke.py``
    holds the kernel against on the card.

H-level fold (``levels >= 3``, DESIGN.md §14): when the prelude carries
the collapsed levels + tail (``pre.upper``) and the background is on, a
second program of the same kernel (compile-time ``UPPER``) folds them in:
the live entries' scores join the row stabilizer ``c`` before any exp, and
``Σ exp(hmu − c)·count·v̄`` joins the background. The wrapper counts its
launches apart from the two-level program's (``upper_launches``).

Dual mode: the kernel runs at two query-tile widths — ``latency``
(C_tile = 1, decode) and ``throughput`` (C_tile = min(C, 8), chunked
prefill) — with ``auto`` resolving from C. Every row's arithmetic is the
same in both modes; only the tiling (and so which rows share a page fetch)
changes. Forward only: the serving path is never differentiated.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import mra_decode
from repro_torch.core.mra import NEG_INF

KERNEL_MODES = ("auto", "latency", "throughput")
THROUGHPUT_C_TILE = 8  # query-tile width of the throughput instantiation
_MAX_SMEM = 232448  # dynamic shared memory a block may use on sm_90 (227 KB)
_CACHE_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def resolve_kernel_mode(mode: str, C: int) -> str:
    """'auto' → latency for single-query (decode) calls, else throughput."""
    if mode not in KERNEL_MODES:
        raise ValueError(
            f"kernel_mode must be one of {KERNEL_MODES}, got {mode!r}")
    if mode == "auto":
        return "latency" if C == 1 else "throughput"
    return mode


def chunk_attention_ref(pre, k_cache, v_cache, q_pos, *, m: int, k_scale=None,
                        v_scale=None, include_bg: bool = True,
                        mode: str = "auto"):
    """Plain PyTorch version of the kernel: the reference's jnp route.

    Same contract as ``chunk_attention_kernel`` (``mode`` only changes the
    kernel's tiling, not the result). The exact term is written over the
    whole cache with a selected-position mask — a page selected by a row
    contributes exactly its positions ``<= q_pos`` — instead of gathering an
    (…, m, b, D) tensor per query; the sums are the reference's. Returns
    (B, Hq, C, D) fp32.
    """
    qg, pb, counts, v_ds, scale = pre.qg, pre.pb, pre.counts, pre.v_ds, pre.scale
    b = pre.block_size
    B, Hkv, G, C, D = qg.shape
    S = k_cache.shape[2]
    cdt = qg.dtype
    sel = mra_decode._select_pages(pre, q_pos, m)
    coarse_m, allowed, own = sel.coarse_m, sel.allowed, sel.ownl
    sel_grid = torch.zeros(coarse_m.shape, dtype=torch.bool,
                           device=coarse_m.device).scatter_(-1, sel.y_idx,
                                                            sel.sel_ok)
    c = torch.clamp(coarse_m.amax(-1), min=NEG_INF * 0.5)  # (B,Hkv,G,C)
    up = pre.upper if include_bg else None  # MRA-2-s ignores the hierarchy
    if up is not None:
        # collapsed levels + tail: strictly past tokens, so liveness is the
        # only gate; their maxima join the stabilizer before any exp
        hlive = (up.counts > 0)[:, None, None, None, :]  # (B,1,1,1,NU)
        hmu = torch.einsum("bhgcd,bhyd->bhgcy", qg,
                           up.k_mean.to(cdt)) * scale
        hmu = torch.where(hlive, hmu, NEG_INF)
        c = torch.maximum(c, hmu.amax(-1))

    # ---- exact term over the selected pages --------------------------------
    kf, vf = k_cache.to(cdt), v_cache.to(cdt)
    if k_scale is not None:  # int8 cache: dequantize with per-token scales
        kf = kf * k_scale.to(cdt)[..., None]
        vf = vf * v_scale.to(cdt)[..., None]
    s = torch.einsum("bhgcd,bhsd->bhgcs", qg, kf) * scale  # (B,Hkv,G,C,S)
    idx = torch.arange(S, device=qg.device)
    page_of = idx // b
    pos = pb[:, page_of] * b + (idx % b)[None, :]  # (B, S) logical positions
    ok = (sel_grid[..., page_of]
          & (pos >= 0)[:, None, None, None, :]
          & (pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]))
    fine_max = torch.where(ok, s, NEG_INF).amax(-1)
    c_tok = torch.maximum(c, fine_max)  # two-level stabilizer
    adj = torch.exp(c - c_tok)
    a = torch.where(ok, torch.exp(torch.clamp(s - c_tok[..., None], max=80.0)),
                    0.0)
    out = torch.einsum("bhgcs,bhsd->bhgcd", a, vf)
    rs = a.sum(-1)

    # ---- coarse background -------------------------------------------------
    if include_bg:
        bg = allowed & ~own & ~sel_grid
        w = torch.where(bg, torch.exp(coarse_m - c[..., None]), 0.0)
        w = w * counts[:, None, None, None, :] * adj[..., None]
        out = out + torch.einsum("bhgcy,bhyd->bhgcd", w, v_ds)
        rs = rs + w.sum(-1)
        if up is not None:
            wh = torch.where(hlive, torch.exp(hmu - c[..., None]), 0.0)
            wh = wh * up.counts[:, None, None, None, :] * adj[..., None]
            out = out + torch.einsum("bhgcy,bhyd->bhgcd", wh,
                                     up.v_mean.to(cdt))
            rs = rs + wh.sum(-1)

    alive = rs > 0
    out = (torch.where(alive[..., None], out, 0.0)
           / torch.where(alive, rs, 1.0)[..., None])
    return out.reshape(B, Hkv * G, C, D)


def chunk_attention_kernel(pre, k_cache, v_cache, q_pos, *, m: int,
                           k_scale=None, v_scale=None, include_bg: bool = True,
                           mode: str = "auto"):
    """Fused chunk/decode attention from the shared page-stats prelude.

    ``pre`` is ``core.mra_decode.ChunkPrelude``; ``m`` the top-m budget;
    ``mode`` one of ``{"auto", "latency", "throughput"}``. Returns
    (B, Hq, C, D) fp32; the caller casts to q's dtype.

    A CUDA cache launches ``csrc/chunk_attn.cu`` on the current stream (no
    synchronisation; launch errors raise): the H-level program when
    ``pre.upper`` is set and ``include_bg`` is on, else the two-level one.
    A CPU cache takes the plain version ``chunk_attention_ref``. There is no
    other route: a CUDA tensor never falls back to the plain version.
    """
    B, Hkv, G, C, D = pre.qg.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "k_scale and v_scale must be provided together (int8 cache), got "
            f"k_scale={'set' if k_scale is not None else None} "
            f"v_scale={'set' if v_scale is not None else None}")
    if tuple(q_pos.shape) != (B, C):
        raise ValueError(
            f"q_pos shape {tuple(q_pos.shape)} does not match the (B, C) = "
            f"({B}, {C}) of queries {tuple(pre.qg.shape)}")
    resolved = resolve_kernel_mode(mode, C)
    if not k_cache.is_cuda:
        return chunk_attention_ref(pre, k_cache, v_cache, q_pos, m=m,
                                   k_scale=k_scale, v_scale=v_scale,
                                   include_bg=include_bg, mode=mode)
    c_tile = 1 if resolved == "latency" else min(C, THROUGHPUT_C_TILE)
    upper = pre.upper if include_bg else None
    out = _launch(pre, k_cache, v_cache, q_pos, m, k_scale, v_scale,
                  include_bg, c_tile, upper)
    if upper is None:
        chunk_attention_kernel.launches += 1
    else:
        chunk_attention_kernel.upper_launches += 1
    return out


# launches of the CUDA kernel's two programs, never reset here
chunk_attention_kernel.launches = 0        # two-level (with_upper=False)
chunk_attention_kernel.upper_launches = 0  # H-level fold (with_upper=True)


def smem_bytes(G: int, c_tile: int, D: int, b: int, nb: int) -> int:
    """Dynamic shared memory of one block; mirrors ``smem_layout`` in the source.

    The same for both programs: the H-level fold streams the collapsed
    entries through the K/V page and score buffers, whatever their count.
    """
    rows = G * c_tile
    floats = (rows * D          # query tile
              + b * (D + 1)     # K page (row padded: conflict-free dots)
              + b * D           # V page
              + rows * b        # page scores / weights
              + 3 * rows * nb   # coarse_m, selection scores, background w
              + rows * D        # accumulator
              + 6 * rows)       # qpos, mt, rs, c, alpha, adj
    return 4 * floats + rows * nb + nb  # + selection flags, page union


def _check(t, name, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .build import load_library

    lib = load_library("chunk_attn")
    if lib.chunk_attn_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chunk_attn_launch.argtypes = (
            [ptr] * 14 + [i32] * 10 + [ctypes.c_float] + [i32] * 3 + [ptr])
        lib.chunk_attn_launch.restype = i32
        lib.chunk_attn_error_string.argtypes = [i32]
        lib.chunk_attn_error_string.restype = ctypes.c_char_p
    return lib


def _launch(pre, k_cache, v_cache, q_pos, m, k_scale, v_scale, include_bg,
            c_tile, upper):
    B, Hkv, G, C, D = pre.qg.shape
    b = pre.block_size
    S = k_cache.shape[2]
    nb = S // b
    dev = k_cache.device
    f32 = (torch.float32,)
    _check(pre.qg, "queries", (B, Hkv, G, C, D), f32, dev)
    _check(k_cache, "k_cache", (B, Hkv, S, D), tuple(_CACHE_DTYPES), dev)
    _check(v_cache, "v_cache", (B, Hkv, S, D), (k_cache.dtype,), dev)
    _check(pre.k_ds, "k_ds", (B, Hkv, nb, D), f32, dev)
    _check(pre.v_ds, "v_ds", (B, Hkv, nb, D), f32, dev)
    _check(pre.counts, "counts", (B, nb), f32, dev)
    _check(pre.pb, "page table", (B, nb), (torch.int32,), dev)
    quant = k_scale is not None
    if quant != (k_cache.dtype == torch.int8):
        raise ValueError(
            "per-token scales go with an int8 cache and only with it "
            f"(cache {k_cache.dtype}, scales {'set' if quant else 'absent'})")
    if quant:
        _check(k_scale, "k_scale", (B, Hkv, S), f32, dev)
        _check(v_scale, "v_scale", (B, Hkv, S), f32, dev)
    nu = 0
    if upper is not None:
        nu = upper.k_mean.shape[2]
        if nu < 1:
            raise ValueError("the H-level view holds no entry (not even the tail)")
        _check(upper.k_mean, "upper k_mean", (B, Hkv, nu, D), f32, dev)
        _check(upper.v_mean, "upper v_mean", (B, Hkv, nu, D), f32, dev)
        _check(upper.counts, "upper counts", (B, nu), f32, dev)
    qpos = q_pos.to(device=dev, dtype=torch.int32).contiguous()
    smem = smem_bytes(G, c_tile, D, b, nb)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"chunk_attn tile needs {smem} bytes of shared memory (G={G}, "
            f"c_tile={c_tile}, D={D}, b={b}, nb={nb}); a block has {_MAX_SMEM}")
    out = torch.empty((B, Hkv * G, C, D), dtype=torch.float32, device=dev)
    lib = _library()
    null = None  # NULL for the scale pointers of a bf16/fp32 cache
    rc = lib.chunk_attn_launch(
        pre.qg.data_ptr(), qpos.data_ptr(), pre.k_ds.data_ptr(),
        pre.v_ds.data_ptr(), pre.counts.data_ptr(), pre.pb.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else null,
        v_scale.data_ptr() if quant else null,
        upper.k_mean.data_ptr() if nu else null,
        upper.v_mean.data_ptr() if nu else null,
        upper.counts.data_ptr() if nu else null,
        out.data_ptr(), B, Hkv, G, C, D, nb, b, m, c_tile, nu,
        float(pre.scale), _CACHE_DTYPES[k_cache.dtype], int(include_bg), smem,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.chunk_attn_error_string(rc).decode()
        raise RuntimeError(f"chunk_attn kernel launch failed: {msg} ({rc})")
    return out
