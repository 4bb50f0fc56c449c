"""Chunk/decode MRA-2 attention: the CUDA serving kernel and its plain twin.

Port of ``repro/kernels/chunk_attn.py`` (DESIGN.md §11). Everything after
the shared page statistics (``core.mra_decode.ChunkPrelude``) — coarse page
scoring, the causal block mask, own-block force selection, top-m selection,
the gathered exact term, the coarse pyramid background and normalization —
is one function with two implementations:

  * ``csrc/chunk_attn.cu`` — a hand-written CUDA C++ kernel for Hopper
    (``sm_90a``), launched by ``chunk_attention_kernel`` for tensors on the
    card. One thread block owns one (batch·kv-head, query-tile, split) tile;
    the exact term runs on tensor cores over pages staged by ``cp.async``;
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

Split decode: when the (batch·kv-head, query-tile) grid is too small for
the card (``split_plan``: under one wave of resident blocks, as at
decode), each row's pages are cut into ``nsplit`` contiguous physical
ranges, one block each; the blocks write partials to scratch and ``chunk_attn_combine_kernel``
merges them (``combine_launches``). ``chunk_attention_split_ref`` is the
plain version of that split-and-merge arithmetic.

Grouped far field (the speculative draft at ``draft_level > 1``): when
the prelude's ``pre.group`` is above 1 and the background is on, a group
of that many adjacent pages that are all background for a row enters
that row's background once, through the group's count-weighted mean
(``group_means``); the group size is a runtime field of the same programs
(1: the per-page background, as before). The kernel needs no group means:
a group's score is the count-weighted mean of its pages' coarse scores,
and its term the sum of its pages' terms at that score.

Shapes: the kernel is built for the (head dim, block size) pairs of
``KERNEL_SHAPES``; the wrapper zero-pads a head dim to the next multiple
of 16 (``pad_head_dim``) and raises on a pair that is not built. At
D = 80 a tile holds at most 16 query rows (``tile_rows``); at D = 112 four
warps own 32 columns each, the last one's ending at D, and a tile holds
16 query rows too.

Page count: each query row's page arrays (coarse scores, selection scores,
flags, the tile's union) take rows·nb·9 + nb·5 bytes. Where they fit in a
block's shared memory the kernel keeps them there; past that (nb beyond
about 1000 pages at a C = 128 tile) ``launch_geometry`` plans the
workspace program, which keeps them in a global workspace the wrapper
allocates before the launch (``workspace_bytes`` a block). Both programs
do the same arithmetic in the same order; both are built for the
two-level and the H-level fold at block 128 (``WORKSPACE_SHAPES``).

Dual mode: the kernel runs at two query-tile widths — ``latency``
(C_tile = 1, decode) and ``throughput`` (C_tile = min(C, 8), chunked
prefill; fewer for G > 4, so that a tile holds at most 32 query rows) —
with ``auto`` resolving from C. Every row's arithmetic is the same in both
modes; only the tiling (and so which rows share a page fetch) changes.
Forward only: the serving path is never differentiated.

Meta tensors (the dry run, ``launch/dryrun.py``) take the meta route: the
shape check and ``plan`` at 132 SMs, the workspace and split scratch
allocated as a launch would, an empty output, the call's operations and
bytes at the selection budget in ``cost.LEDGER`` (a shape no kernel is
built for is recorded there, not raised).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import mra_decode
from repro_torch.core.mra import NEG_INF

from . import cost
from .block_sparse_attn import _BLOCK_RESERVED, _SM_SMEM, SMS, padded_dim

KERNEL_MODES = ("auto", "latency", "throughput")
THROUGHPUT_C_TILE = 8  # query-tile width of the throughput instantiation
# (head dim D padded to a multiple of 16, block size b) the kernel is built
# for: qwen3-1.7b / llama3.2-3b / qwen2-7b / yi-6b, their smoke configs,
# granite-moe-3b-a800m and internvl2-1b, hubert-xlarge, kimi-k2-1t-a32b
KERNEL_SHAPES = ((128, 128), (16, 16), (64, 128), (80, 128), (112, 128))
# the shapes whose programs (two-level and H-level) are also built with the
# page arrays in a global workspace (the smoke shape stays within shared
# memory)
WORKSPACE_SHAPES = ((128, 128), (64, 128), (80, 128), (112, 128))
MAX_TILE_ROWS = 32  # G·C_tile query rows of one tile (two m16 row tiles)
_MAX_SMEM = 232448  # dynamic shared memory a block may use on sm_90 (227 KB)
_CACHE_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
# per storage type: bytes of an element, keys per ring stage, int8 scales
_STORAGE = {torch.bfloat16: (2, 64, False), torch.int8: (1, 64, True),
            torch.float32: (4, 32, False)}
_ENTRY_TILE = 16  # fp32 collapsed entries per ring stage
_RING_SLOTS = 2


def resolve_kernel_mode(mode: str, C: int) -> str:
    """'auto' → latency for single-query (decode) calls, else throughput."""
    if mode not in KERNEL_MODES:
        raise ValueError(
            f"kernel_mode must be one of {KERNEL_MODES}, got {mode!r}")
    if mode == "auto":
        return "latency" if C == 1 else "throughput"
    return mode


def warp_columns(D: int) -> tuple:
    """(warps splitting D, columns a warp owns at most); mirrors ``Geo`` in
    the source: 32 columns a warp where 32 divides D; one warp for all of a
    D up to 96 that it does not divide (D = 80); past that four warps of
    32, the last one's columns ending at D (D = 112)."""
    if D % 32 == 0:
        nwd = max(1, min(4, D // 32))
    else:
        nwd = 4 if D > 96 else 1
    return nwd, -(-(D // nwd) // 16) * 16


def tile_rows(D: int) -> int:
    """Query rows a tile holds at head dim D: two m16 tiles, one where a
    warp owns more than 32 columns (D = 80) or the last warp's columns end
    short of D (D = 112)."""
    nwd, ds = warp_columns(D)
    return 16 if ds > 32 or nwd * ds > D else MAX_TILE_ROWS


def tile_width(mode: str, C: int, G: int, D: int | None = None) -> int:
    """Query positions per tile (C_tile) of the resolved ``mode`` (at head
    dim ``D``, as launched; None: a D of two row tiles)."""
    rows = MAX_TILE_ROWS if D is None else tile_rows(D)
    if G > rows:
        raise ValueError(f"{G} query heads per KV head exceed the kernel's "
                         f"{rows} rows a tile")
    if resolve_kernel_mode(mode, C) == "latency":
        return 1
    return min(C, THROUGHPUT_C_TILE, rows // G)


def split_ranges(nb: int, nsplit: int):
    """Split s's contiguous range [s·nb // nsplit, (s+1)·nb // nsplit) of
    physical pages; together they cover each page exactly once."""
    return [(s * nb // nsplit, (s + 1) * nb // nsplit) for s in range(nsplit)]


def split_plan(B: int, Hkv: int, tiles: int, nb: int, sms: int,
               per_sm: int = 2):
    """(nsplit, page ranges) for a grid of B·Hkv·tiles blocks on ``sms`` SMs
    that hold ``per_sm`` blocks each.

    Every split repeats its row's selection over all nb pages, so splitting
    pays only while the splits run side by side: nsplit is the largest
    power of two (at most nb, so every split owns a page) whose grid fits
    one wave of resident blocks, sms·per_sm; 1 where the unsplit grid fills
    that wave already (every chunked prefill at C >= 128 of the served
    configs). A second wave repeats the selection and hides no more
    latency (PERF.md §6: one wave was the fastest count, or within 5% of
    it, at each measured decode and prefill shape).
    """
    blocks = B * Hkv * tiles
    nsplit = 1
    while blocks * nsplit * 2 <= sms * per_sm and 2 * nsplit <= nb:
        nsplit *= 2
    return nsplit, split_ranges(nb, nsplit)


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def row_stride(nbytes: int) -> int:
    """Bytes between staged rows of ``nbytes``: the row itself when its
    16-byte chunks number a power of two (XOR-swizzled), else padded to an
    odd count of chunks (``ChunkRow`` in ``csrc/sm90_mma.cuh``)."""
    chunks = nbytes // 16
    return nbytes if chunks & (chunks - 1) == 0 else (chunks | 1) * 16


def workspace_bytes(rows: int, nb: int) -> int:
    """Bytes of one block's per-row page arrays (``page_bytes`` in the
    source): coarse_m and the selection scores / w (rows x nb floats), the
    selection flags (rows x nb), the page union (nb) and the split's union
    list (nb ints). In shared memory, or the block's slice of the
    workspace program's global workspace."""
    return (2 * _a16(rows * nb * 4) + _a16(rows * nb) + _a16(nb)
            + _a16(nb * 4))


def smem_bytes(G: int, c_tile: int, D: int, b: int, nb: int,
               cache_dtype, workspace: bool = False) -> int:
    """Dynamic shared memory of one block; mirrors ``smem_layout`` in the
    source (``workspace``: the program whose page arrays are in global
    memory). The same for the two-level and H-level programs (the fold
    streams the collapsed entries through the ring in tiles of 16, whatever
    their count) and at any draft group size."""
    size, keys, quant = _STORAGE[cache_dtype]
    rows = G * c_tile
    rp = 16 * -(-rows // 16)              # rows padded to m16 tiles
    kt = min(keys, b)                     # keys per ring stage
    nwd = warp_columns(D)[0]              # warps splitting D
    stage = 2 * kt * row_stride(D * size) + (2 * kt * 4 if quant else 0)
    slot = _a16(max(stage, 2 * _ENTRY_TILE * row_stride(D * 4)))
    xs = max(kt, _ENTRY_TILE) + 8         # padded exchange row (floats)
    return (_a16(max(_RING_SLOTS * slot, rp * D * 4))  # ring / q tile
            + (_a16(nwd * rp * xs * 4) if nwd > 1 else 0)  # score exchange
            + (0 if workspace else workspace_bytes(rows, nb))  # page arrays
            + 3 * _a16(rp * 4)            # qpos, c, background row sums
            + 16)                         # the union list's count


def _exact_inputs(pre, k_cache, v_cache, q_pos, m, k_scale, v_scale,
                  include_bg):
    """What the exact term and the background share: the selection, the
    stabilizer c (with the live collapsed maxima), scores and their mask."""
    qg, pb, scale = pre.qg, pre.pb, pre.scale
    b = pre.block_size
    S = k_cache.shape[2]
    cdt = qg.dtype
    sel = mra_decode._select_pages(pre, q_pos, m)
    sel_grid = torch.zeros(sel.coarse_m.shape, dtype=torch.bool,
                           device=sel.coarse_m.device).scatter_(
                               -1, sel.y_idx, sel.sel_ok)
    c = torch.clamp(sel.coarse_m.amax(-1), min=NEG_INF * 0.5)  # (B,Hkv,G,C)
    up = pre.upper if include_bg else None  # MRA-2-s ignores the hierarchy
    hmu = hlive = None
    if up is not None:
        # collapsed levels + tail: strictly past tokens, so liveness is the
        # only gate; their maxima join the stabilizer before any exp
        hlive = (up.counts > 0)[:, None, None, None, :]  # (B,1,1,1,NU)
        hmu = torch.einsum("bhgcd,bhyd->bhgcy", qg,
                           up.k_mean.to(cdt)) * scale
        hmu = torch.where(hlive, hmu, NEG_INF)
        c = torch.maximum(c, hmu.amax(-1))
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
    return sel, sel_grid, c, up, hmu, hlive, s, ok, vf, page_of


def group_means(pre):
    """(k_g, v_g, count_g) of the draft's groups of ``pre.group`` adjacent
    pages: count-weighted means of the pages' means (B, Hkv, nb / group, D)
    and the tokens of each group (B, nb / group), as the reference's
    grouped fold computes them."""
    gsz = pre.group
    B, Hkv, nb, D = pre.k_ds.shape
    ng = nb // gsz
    cnt_g = pre.counts.reshape(B, ng, gsz).sum(-1)
    den_g = torch.clamp(cnt_g, min=1.0)[:, None, :, None]
    w = pre.counts[:, None, :, None]
    k_g = (pre.k_ds * w).reshape(B, Hkv, ng, gsz, D).sum(3) / den_g
    v_g = (pre.v_ds * w).reshape(B, Hkv, ng, gsz, D).sum(3) / den_g
    return k_g, v_g, cnt_g


def _add_background(pre, sel, sel_grid, c, up, hmu, hlive, out, rs, adj):
    """out, rs plus the background on the stabilizer c, times ``adj`` where
    given (the plain route's order of operations): the draft's groups whose
    every page is background (``pre.group`` > 1) through their means, then
    the other background pages, then the collapsed entries."""
    bg = sel.allowed & ~sel.ownl & ~sel_grid
    if pre.group > 1:  # a group folds where every page is background
        k_g, v_g, cnt_g = group_means(pre)
        whole = bg.reshape(*bg.shape[:-1], -1, pre.group).all(-1)
        mu = torch.einsum("bhgcd,bhyd->bhgcy", pre.qg, k_g) * pre.scale
        wg = torch.where(whole, torch.exp(mu - c[..., None]), 0.0)
        wg = wg * cnt_g[:, None, None, None, :]
        if adj is not None:
            wg = wg * adj[..., None]
        out = out + torch.einsum("bhgcy,bhyd->bhgcd", wg, v_g)
        rs = rs + wg.sum(-1)
        bg = bg & ~torch.repeat_interleave(whole, pre.group, dim=-1)
    w = torch.where(bg, torch.exp(sel.coarse_m - c[..., None]), 0.0)
    w = w * pre.counts[:, None, None, None, :]
    if adj is not None:
        w = w * adj[..., None]
    out = out + torch.einsum("bhgcy,bhyd->bhgcd", w, pre.v_ds)
    rs = rs + w.sum(-1)
    if up is not None:
        wh = torch.where(hlive, torch.exp(hmu - c[..., None]), 0.0)
        wh = wh * up.counts[:, None, None, None, :]
        if adj is not None:
            wh = wh * adj[..., None]
        out = out + torch.einsum("bhgcy,bhyd->bhgcd", wh,
                                 up.v_mean.to(pre.qg.dtype))
        rs = rs + wh.sum(-1)
    return out, rs


def _normalize(out, rs):
    alive = rs > 0
    B, Hkv, G, C, D = out.shape
    out = (torch.where(alive[..., None], out, 0.0)
           / torch.where(alive, rs, 1.0)[..., None])
    return out.reshape(B, Hkv * G, C, D)


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
    sel, sel_grid, c, up, hmu, hlive, s, ok, vf, _ = _exact_inputs(
        pre, k_cache, v_cache, q_pos, m, k_scale, v_scale, include_bg)
    fine_max = torch.where(ok, s, NEG_INF).amax(-1)
    c_tok = torch.maximum(c, fine_max)  # two-level stabilizer
    adj = torch.exp(c - c_tok)
    a = torch.where(ok, torch.exp(torch.clamp(s - c_tok[..., None], max=80.0)),
                    0.0)
    out = torch.einsum("bhgcs,bhsd->bhgcd", a, vf)
    rs = a.sum(-1)
    if include_bg:  # the coarse background, on c_tok through adj
        out, rs = _add_background(pre, sel, sel_grid, c, up, hmu, hlive, out,
                                  rs, adj)
    return _normalize(out, rs)


def chunk_attention_split_ref(pre, k_cache, v_cache, q_pos, *, m: int,
                              nsplit: int, k_scale=None, v_scale=None,
                              include_bg: bool = True):
    """Plain version of the split kernel and its combine.

    Split s runs ``chunk_attention_ref``'s exact-term arithmetic over the
    pages of its range (``split_ranges``) alone, with its own running max
    mt_s; the merge takes M = max mt_s, rs = Σ rs_s·exp(mt_s − M) and acc
    likewise in ascending split order, then normalizes with the two-level
    stabilizer c_tok = max(c, M), as ``chunk_attn_combine_kernel`` does.
    Equal to ``chunk_attention_ref`` up to rounding. Returns (B, Hq, C, D).
    """
    sel, sel_grid, c, up, hmu, hlive, s, ok, vf, page_of = _exact_inputs(
        pre, k_cache, v_cache, q_pos, m, k_scale, v_scale, include_bg)
    parts = []
    for p0, p1 in split_ranges(pre.pb.shape[1], nsplit):
        ok_s = ok & ((page_of >= p0) & (page_of < p1))
        mt = torch.where(ok_s, s, NEG_INF).amax(-1)
        a = torch.where(ok_s, torch.exp(torch.clamp(s - mt[..., None],
                                                    max=80.0)), 0.0)
        parts.append((mt, a.sum(-1), torch.einsum("bhgcs,bhsd->bhgcd", a, vf)))
    M = torch.stack([mt for mt, _, _ in parts]).amax(0)
    rs = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for mt, l, x in parts:
        w = torch.exp(mt - M)
        rs = rs + l * w
        acc = acc + x * w[..., None]
    c_tok = torch.maximum(c, M)
    fine_adj, adj = torch.exp(M - c_tok), torch.exp(c - c_tok)
    out, rs = acc * fine_adj[..., None], rs * fine_adj
    if include_bg:  # split 0's numerator and row sum on c, then adj
        num, den = _add_background(pre, sel, sel_grid, c, up, hmu, hlive,
                                   torch.zeros_like(out), torch.zeros_like(rs),
                                   None)
        out = out + adj[..., None] * num
        rs = rs + adj * den
    return _normalize(out, rs)


def chunk_attention_kernel(pre, k_cache, v_cache, q_pos, *, m: int,
                           k_scale=None, v_scale=None, include_bg: bool = True,
                           mode: str = "auto"):
    """Fused chunk/decode attention from the shared page-stats prelude.

    ``pre`` is ``core.mra_decode.ChunkPrelude``; ``m`` the top-m budget;
    ``mode`` one of ``{"auto", "latency", "throughput"}``. Returns
    (B, Hq, C, D) fp32; the caller casts to q's dtype.

    A CUDA cache launches ``csrc/chunk_attn.cu`` on the current stream (no
    synchronisation; launch errors raise): the H-level program when
    ``pre.upper`` is set and ``include_bg`` is on, else the two-level one,
    split across blocks (and merged by the combine kernel) where
    ``split_plan`` says so. A head dim that is not a multiple of 16 is
    zero-padded to the next one first (exact for every product; the output
    is cut back), and a padded (D, b) the kernel is not built for raises.
    A CPU cache takes the plain version ``chunk_attention_ref``. There is
    no other route: a CUDA tensor never falls back to the plain version.
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
    resolve_kernel_mode(mode, C)
    if k_cache.is_meta:
        return _meta_call(pre, k_cache, m, k_scale is not None, include_bg,
                          mode)
    if not k_cache.is_cuda:
        return chunk_attention_ref(pre, k_cache, v_cache, q_pos, m=m,
                                   k_scale=k_scale, v_scale=v_scale,
                                   include_bg=include_bg, mode=mode)
    pre, k_cache, v_cache = pad_head_dim(pre, k_cache, v_cache)
    out = _launch(pre, k_cache, v_cache, q_pos, m=m, k_scale=k_scale,
                  v_scale=v_scale, include_bg=include_bg, mode=mode)
    return out if out.shape[-1] == D else out[..., :D].contiguous()


# launches of the CUDA kernels, never reset here
chunk_attention_kernel.launches = 0          # two-level (with_upper=False)
chunk_attention_kernel.upper_launches = 0    # H-level fold (with_upper=True)
chunk_attention_kernel.combine_launches = 0  # merges of split blocks


def _meta_call(pre, k_cache, m, quant, include_bg, mode):
    """The meta route: plan the launch as on the card (head dim padded),
    allocate its scratch, record its cost, return an empty output."""
    B, Hkv, G, C, D = pre.qg.shape
    b, nb = pre.block_size, pre.pb.shape[1]
    Dp = padded_dim(D)
    up = pre.upper if include_bg else None
    nu = 0 if up is None else up.k_mean.shape[2]
    name = "chunk_attn_upper" if nu else "chunk_attn"
    out = torch.empty((B, Hkv * G, C, D), dtype=torch.float32,
                      device=k_cache.device)
    try:
        geo = plan(B, Hkv, G, C, Dp, b, nb, k_cache.dtype, mode=mode,
                   sms=SMS, upper=nu > 0)
    except ValueError:
        cost.LEDGER.refuse(name, (Dp, b))
        return out
    ns = geo["nsplit"]
    scratch = [torch.empty(geo["ws_bytes"], dtype=torch.uint8,
                           device=k_cache.device)]
    if ns > 1:
        scratch.append(torch.empty(B * Hkv * geo["tiles"] * (ns + 1) * G
                                   * geo["c_tile"] * (Dp + 2),
                                   dtype=torch.float32, device=k_cache.device))
    union, pairs = cost.chunk_budget(B, Hkv, G, C, b, nb, m, geo["c_tile"])
    key = (f"B={B} Hkv={Hkv} G={G} C={C} D={Dp} b={b} nb={nb} "
           f"{str(k_cache.dtype)[6:]} nsplit={ns}"
           + (" workspace" if geo["workspace"] else ""))
    cost.LEDGER.record(name, key, cost.chunk_cost(
        B, Hkv, G, C, Dp, b, nb, k_cache.element_size(), quant, union, pairs,
        nu))
    if ns > 1:
        cost.LEDGER.record("chunk_attn_combine", key, {
            "flops": 0, "bytes": scratch[-1].numel() * 4 + out.numel() * 4})
    del scratch
    return out


def _check(t, name, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_shape(D: int, b: int) -> None:
    """Raise unless the kernel is built for head dim D (as launched, after
    ``pad_head_dim``) and block size b."""
    if (D, b) not in KERNEL_SHAPES:
        raise ValueError(
            f"chunk_attn is built for (head dim, block size) in "
            f"{list(KERNEL_SHAPES)}, not ({D}, {b})")


def pad_head_dim(pre, k_cache, v_cache):
    """(pre, k_cache, v_cache) with every head-dim axis (queries, page and
    collapsed means, cache rows) zero-padded to ``padded_dim``; as they are
    when D is a multiple of 16 already. Padding adds zero terms to every
    dot product and zero output columns, so the kernel's result on the
    first D columns is unchanged."""
    D = pre.qg.shape[-1]
    pad = padded_dim(D) - D
    if pad == 0:
        return pre, k_cache, v_cache

    def z(t):
        return torch.nn.functional.pad(t, (0, pad))

    up = pre.upper
    if up is not None:
        up = up._replace(k_mean=z(up.k_mean), v_mean=z(up.v_mean))
    return (pre._replace(qg=z(pre.qg), k_ds=z(pre.k_ds), v_ds=z(pre.v_ds),
                         upper=up), z(k_cache), z(v_cache))


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .build import load_library

    lib = load_library("chunk_attn")
    if lib.chunk_attn_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chunk_attn_launch.argtypes = (
            [ptr] * 16 + [i32] * 12 + [ctypes.c_float] + [i32] * 3 + [ptr])
        lib.chunk_attn_launch.restype = i32
        lib.chunk_attn_combine_launch.argtypes = [ptr] * 2 + [i32] * 7 + [ptr]
        lib.chunk_attn_combine_launch.restype = i32
        lib.chunk_attn_blocks_per_sm.argtypes = [i32] * 6 + [
            ctypes.POINTER(i32)]
        lib.chunk_attn_blocks_per_sm.restype = i32
        for fn in (lib.chunk_attn_smem_bytes, lib.chunk_attn_smem_bytes_ws):
            fn.argtypes = [i32] * 5
            fn.restype = ctypes.c_longlong
        lib.chunk_attn_workspace_bytes.argtypes = [i32] * 2
        lib.chunk_attn_workspace_bytes.restype = ctypes.c_longlong
        lib.chunk_attn_error_string.argtypes = [i32]
        lib.chunk_attn_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.chunk_attn_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg} ({rc})")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def blocks_per_sm(cache_dtype, D: int, b: int, upper: bool, smem: int,
                  workspace: bool = False) -> int:
    """Blocks of one program that fit on an SM (the CUDA occupancy API)."""
    lib = _library()
    n = ctypes.c_int(0)
    _raise_on(lib, lib.chunk_attn_blocks_per_sm(
        _CACHE_DTYPES[cache_dtype], D, b, int(upper), int(workspace), smem,
        ctypes.byref(n)), "chunk_attn occupancy query")
    return n.value


def plan(B: int, Hkv: int, G: int, C: int, D: int, b: int, nb: int,
         cache_dtype, *, mode: str = "auto", nsplit: int | None = None,
         sms: int = 132, workspace: bool | None = None,
         upper: bool = False) -> dict:
    """Tile width, grid, split, program and shared memory of a launch at
    these shapes (D as launched, after ``pad_head_dim``; ``upper``: the
    H-level program). ``workspace`` None takes the workspace program only
    where the shared-memory layout does not fit a block; ``ws_bytes`` is
    then its global workspace (0 otherwise). Raises where no built program
    fits: the workspace program is built for WORKSPACE_SHAPES (both
    programs)."""
    check_shape(D, b)
    c_tile = tile_width(mode, C, G, D)
    tiles = -(-C // c_tile)
    if workspace is None:
        workspace = smem_bytes(G, c_tile, D, b, nb, cache_dtype) > _MAX_SMEM
    if workspace and (D, b) not in WORKSPACE_SHAPES:
        raise ValueError(
            f"chunk_attn's workspace program is built at "
            f"{list(WORKSPACE_SHAPES)}, not ({D}, {b}) (nb={nb})")
    smem = smem_bytes(G, c_tile, D, b, nb, cache_dtype, workspace)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"chunk_attn tile needs {smem} bytes of shared memory (G={G}, "
            f"c_tile={c_tile}, D={D}, b={b}, nb={nb}); a block has {_MAX_SMEM}")
    if nsplit is None:  # two blocks an SM (the launch bounds) where they fit
        per_sm = min(2, _SM_SMEM // (smem + _BLOCK_RESERVED))
        nsplit = split_plan(B, Hkv, tiles, nb, sms, per_sm)[0]
    if not 1 <= nsplit <= nb:
        raise ValueError(f"nsplit {nsplit} outside [1, nb = {nb}]")
    blocks = B * Hkv * tiles * nsplit
    return {"c_tile": c_tile, "rows": G * c_tile, "tiles": tiles,
            "nsplit": nsplit, "grid": [B * Hkv, tiles, nsplit],
            "smem": smem, "workspace": workspace,
            "ws_bytes": blocks * workspace_bytes(G * c_tile, nb)
            if workspace else 0}


def launch_geometry(pre, cache_dtype, *, mode: str = "auto",
                    nsplit: int | None = None, sms: int = 132,
                    workspace: bool | None = None,
                    upper: bool = False) -> dict:
    """``plan`` of a launch on ``pre`` (its head dim as given)."""
    B, Hkv, G, C, D = pre.qg.shape
    return plan(B, Hkv, G, C, D, pre.block_size, pre.pb.shape[1],
                cache_dtype, mode=mode, nsplit=nsplit, sms=sms,
                workspace=workspace, upper=upper)


def _launch(pre, k_cache, v_cache, q_pos, *, m, k_scale=None, v_scale=None,
            include_bg=True, mode="auto", nsplit=None, workspace=None):
    """Launch the kernel (and the combine where split) on CUDA tensors.

    ``nsplit`` None takes ``split_plan``'s and ``workspace`` None the
    plan's program; explicit values are for tests and ``chip_smoke.py``
    only. Counts each launch where it is made.
    """
    B, Hkv, G, C, D = pre.qg.shape
    b = pre.block_size
    S = k_cache.shape[2]
    nb = S // b
    dev = k_cache.device
    check_shape(D, b)
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
    upper = pre.upper if include_bg else None
    nu = 0
    if upper is not None:
        nu = upper.k_mean.shape[2]
        if nu < 1:
            raise ValueError("the H-level view holds no entry (not even the tail)")
        _check(upper.k_mean, "upper k_mean", (B, Hkv, nu, D), f32, dev)
        _check(upper.v_mean, "upper v_mean", (B, Hkv, nu, D), f32, dev)
        _check(upper.counts, "upper counts", (B, nu), f32, dev)
    gsz = pre.group if include_bg else 1
    if gsz < 1 or nb % gsz:
        raise ValueError(f"draft group of {gsz} pages does not divide "
                         f"nb={nb}")
    geo = launch_geometry(pre, k_cache.dtype, mode=mode, nsplit=nsplit,
                          sms=sm_count(dev.index if dev.index is not None
                                       else torch.cuda.current_device()),
                          workspace=workspace, upper=nu > 0)
    c_tile, tiles, ns, smem = (geo[k] for k in ("c_tile", "tiles", "nsplit",
                                                "smem"))
    # the workspace program's page arrays: one 16-byte aligned slice a block
    ws = (torch.empty(geo["ws_bytes"], dtype=torch.uint8, device=dev)
          if geo["workspace"] else None)
    qpos = q_pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, Hkv * G, C, D), dtype=torch.float32, device=dev)
    part = None
    if ns > 1:  # per (row, tile): ns partials (acc, max, sum) and split 0's
        # background (numerator, c, sum), G·c_tile rows each (part_stride)
        part = torch.empty(B * Hkv * tiles * (ns + 1) * G * c_tile * (D + 2),
                           dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    null = None  # NULL for the pointers a program does not read
    _raise_on(lib, lib.chunk_attn_launch(
        pre.qg.data_ptr(), qpos.data_ptr(), pre.k_ds.data_ptr(),
        pre.v_ds.data_ptr(), pre.counts.data_ptr(), pre.pb.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else null,
        v_scale.data_ptr() if quant else null,
        upper.k_mean.data_ptr() if nu else null,
        upper.v_mean.data_ptr() if nu else null,
        upper.counts.data_ptr() if nu else null,
        out.data_ptr(), part.data_ptr() if ns > 1 else null,
        ws.data_ptr() if ws is not None else null, B, Hkv, G, C, D, nb, b,
        m, c_tile, nu, gsz, ns, float(pre.scale),
        _CACHE_DTYPES[k_cache.dtype], int(include_bg), smem, stream),
        "chunk_attn kernel launch")
    if nu:
        chunk_attention_kernel.upper_launches += 1
    else:
        chunk_attention_kernel.launches += 1
    if ns > 1:
        _raise_on(lib, lib.chunk_attn_combine_launch(
            part.data_ptr(), out.data_ptr(), B, Hkv, G, C, D, c_tile, ns,
            stream), "chunk_attn combine launch")
        chunk_attention_kernel.combine_launches += 1
    return out
