"""Block-sparse attention for training: the CUDA kernels and their plain twins.

Port of ``repro/kernels/{block_sparse_attn,ops,ref}.py`` (DESIGN.md §3).
``block_sparse_attention`` is a ``torch.autograd.Function`` with the
reference's I/O contract: for each selected (query block, key block) pair
of a BHG row it computes the masked scores q·kᵀ·scale and returns the
*unnormalized* numerator, the row sums and the per-token stabilizer ``mt``
(the floor ``c`` raised to the exact masked score max, so every weight is
≤ 1). ``mt`` is gradient-transparent and dc ≡ 0: the stabilizer cancels in
the caller's normalization. The backward recomputes the weights from
``mt`` (flash-style, nothing of size O(m·b²) is saved).

Two implementations of each pass, chosen by the tensors' device:

  * ``csrc/block_sparse_attn.cu`` — hand-written CUDA C++ for Hopper
    (``sm_90a``): ``bsa_fwd``, ``bsa_bwd_dq`` and ``bsa_bwd_dkv`` launch the
    forward, dq and dk/dv kernels for tensors on the card. Each output tile
    has one owning thread block that walks that tile's CSR list of pairs
    (``group_by_query`` / ``group_by_key`` below), so results are bitwise
    deterministic; the note at the top of the source says what bounds them.
    All three run their products on tensor cores (bf16 operands, an fp32
    one split into three bf16 terms) over tiles staged by ``cp.async``, one
    warp per 16 output rows, output tiles launched heaviest first
    (``tile_order``); ``kernel_plan`` mirrors their geometry and shared
    memory. They are built for the (head dim, block size) pairs of
    ``KERNEL_SHAPES``, a head dim zero-padded to the next multiple of 16;
    ``check_shape`` refuses any other pair before a launch.
  * ``block_sparse_attention_ref`` / ``block_sparse_attention_bwd_ref`` —
    the plain PyTorch versions of the reference's ``kernels/ref.py``, taken
    for tensors on the CPU and held against the kernels on the card
    (``block_sparse_attention_bwd_dq_ref`` / ``..._dkv_ref`` are the
    backward's two halves alone, each the twin of one backward kernel).

There is no other route: a CUDA tensor never takes the plain version.
Tensors on the meta device (the dry run, ``launch/dryrun.py``) take the
meta route: the kernels' shape check and plan, then empty outputs of their
shapes, each call's operations and bytes recorded in ``cost.LEDGER`` (a
shape no kernel is built for is recorded there, not raised).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.mra import NEG_INF

from . import cost

# (head dim padded to a multiple of 16, block size b) the three kernels are
# built for: qwen3-1.7b, the reference's (64, 64) and smoke (16, 16) shapes,
# granite-moe-3b-a800m and internvl2-1b, hubert-xlarge, kimi-k2-1t-a32b
# (head dim 112), the H-Transformer-1D baseline (core/baselines.py: head
# dim 64, block 32), examples/train_lm.py's small preset (head dim 32,
# block 32) and recurrentgemma-9b's local layers under MRA-2 (head dim 256)
KERNEL_SHAPES = ((128, 128), (64, 64), (16, 16), (64, 128), (80, 128),
                 (112, 128), (64, 32), (32, 32), (256, 128))
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_KERNELS = {"fwd": 0, "dkv": 1, "dq": 2}  # the kernels of the source
_SM_SMEM = 233472   # shared memory of an SM (228 KB)
_BLOCK_RESERVED = 1024  # shared memory the runtime keeps per block
_SM_THREADS = 2048


# --------------------------------------------------------------------------- #
# plain versions (reference kernels/ref.py)
# --------------------------------------------------------------------------- #
def _gather_blocks(x, idx, b: int):
    """x (R, n, d), idx (R, m) block ids -> (R, m, b, d)."""
    R, n, d = x.shape
    return x.reshape(R, n // b, b, d)[torch.arange(R, device=x.device)[:, None],
                                      idx.long()]


def _expand_kv(x, G: int):
    """(BHKV, n, ...) -> (BHG, n, ...) by repeating each KV head G times."""
    return x[:, None].expand(x.shape[0], G, *x.shape[1:]).reshape(
        x.shape[0] * G, *x.shape[1:])


def _block_mask(flags, km_blk, b: int):
    """(BHG, m) flags (+ (BHG, m, b) key mask) -> (BHG, m, b, b) bool.

    flags bit0: pair valid; bit1: causal triangle (diagonal blocks)."""
    valid = (flags & 1) == 1
    diag = (flags & 2) == 2
    r = torch.arange(b, device=flags.device)
    tri = r[:, None] >= r[None, :]
    mask = torch.where(diag[..., None, None], tri, True)
    mask = mask & valid[..., None, None]
    if km_blk is not None:
        mask = mask & (km_blk > 0)[..., None, :]
    return mask


def _recompute(q, k, c, x_idx, y_idx, flags, key_mask, *, scale, block_size):
    """Masked scores, per-token stabilizer and weights (reference ref.py).

    Returns (a, q_blk, k_blk, mt): a (BHG, m, b, b) = mask·exp(s − mt),
    mt (BHG, nb, b) = max(c floor, masked score row maxima), detached.
    """
    b = block_size
    BHG, n, _ = q.shape
    nb = n // b
    G = BHG // k.shape[0]
    x = x_idx.long()
    q_blk = _gather_blocks(q.to(torch.float32), x, b)
    k_blk = _gather_blocks(_expand_kv(k, G).to(torch.float32), y_idx, b)
    s = torch.einsum("rmid,rmjd->rmij", q_blk, k_blk) * scale
    km_blk = None
    if key_mask is not None:
        kmx = _expand_kv(key_mask.to(torch.float32), G).reshape(BHG, nb, b)
        km_blk = kmx[torch.arange(BHG, device=q.device)[:, None], y_idx.long()]
    mask = _block_mask(flags, km_blk, b)

    row_max = torch.where(mask, s, NEG_INF).amax(-1)  # (BHG, m, b)
    base = c[..., None].expand(BHG, nb, b).to(torch.float32)
    xi = x[..., None].expand(-1, -1, b)
    mt = base.scatter_reduce(1, xi, row_max, "amax", include_self=True).detach()

    mt_sel = torch.gather(mt, 1, xi)  # (BHG, m, b)
    # valid entries satisfy s <= mt by construction; masked lanes are
    # sanitized before exp (the where-grad 0·inf guard)
    arg = torch.where(mask, s - mt_sel[..., None], 0.0)
    a = torch.where(mask, torch.exp(arg), 0.0)
    return a, q_blk, k_blk, mt


def _segment_add(values, idx, nb: int):
    """Sum (R, m, ...) block values into (R, nb, ...) by block id.

    A product with the (R, m, nb) one-hot map of ``idx``: the sum runs in
    the GEMM's fixed order (the zero terms add exactly nothing), so a rerun
    on the card is bitwise equal, where ``scatter_add``'s CUDA atomics sum
    in whatever order they land. fp32 values need fp32 products (TF32 off,
    torch's default)."""
    R, m = idx.shape
    onehot = (idx.long()[..., None]
              == torch.arange(nb, device=idx.device)).to(values.dtype)
    out = torch.bmm(onehot.transpose(1, 2), values.reshape(R, m, -1))
    return out.reshape((R, nb) + tuple(values.shape[2:]))


def block_sparse_attention_ref(q, k, v, x_idx, y_idx, flags, c,
                               key_mask=None, *, scale: float,
                               block_size: int):
    """Plain forward: (out (BHG,n,d), rowsum (BHG,n), mt (BHG,n)), fp32.

    A query tile that no pair visits comes out as 0 / 0 / c.
    """
    BHG, n, d = q.shape
    G = BHG // k.shape[0]
    b = block_size
    nb = n // b
    a, _, _, mt = _recompute(q, k, c, x_idx, y_idx, flags, key_mask,
                             scale=scale, block_size=b)
    v_blk = _gather_blocks(_expand_kv(v, G).to(torch.float32), y_idx, b)
    o_blk = torch.einsum("rmij,rmjd->rmid", a, v_blk)
    out = _segment_add(o_blk, x_idx, nb).reshape(BHG, n, d)
    rowsum = _segment_add(a.sum(-1), x_idx, nb).reshape(BHG, n)
    return out, rowsum, mt.reshape(BHG, n)


class _BwdTerms(NamedTuple):
    """What the plain dq and dk/dv passes share: per pair, the weights
    a = mask·exp(s − mt_x), ds = a ⊙ (do_x v_yᵀ + dr_x) and the gathered
    q / k / do blocks, all fp32."""

    a: torch.Tensor
    ds: torch.Tensor
    q_blk: torch.Tensor
    k_blk: torch.Tensor
    do_blk: torch.Tensor


def _bwd_terms(q, k, v, c, x_idx, y_idx, flags, key_mask, do, dr, *,
               scale: float, block_size: int) -> _BwdTerms:
    BHG, n, _ = q.shape
    G = BHG // k.shape[0]
    b = block_size
    a, q_blk, k_blk, _ = _recompute(q, k, c, x_idx, y_idx, flags, key_mask,
                                    scale=scale, block_size=b)
    v_blk = _gather_blocks(_expand_kv(v, G).to(torch.float32), y_idx, b)
    do_blk = _gather_blocks(do.to(torch.float32), x_idx, b)
    dr_blk = dr.to(torch.float32).reshape(BHG, n // b, b)[
        torch.arange(BHG, device=q.device)[:, None], x_idx.long()]
    ds = a * (torch.einsum("rmid,rmjd->rmij", do_blk, v_blk) + dr_blk[..., None])
    return _BwdTerms(a, ds, q_blk, k_blk, do_blk)


def _dq_of(t: _BwdTerms, x_idx, shape, scale: float):
    """dq_x += ds k_y·scale, summed into (BHG, n, d)."""
    BHG, n, d = shape
    dq_blk = torch.einsum("rmij,rmjd->rmid", t.ds, t.k_blk) * scale
    return _segment_add(dq_blk, x_idx, n // t.a.shape[-1]).reshape(BHG, n, d)


def _dkv_of(t: _BwdTerms, y_idx, shape, BHKV: int, scale: float):
    """dk_y += dsᵀ q_x·scale and dv_y += aᵀ do_x, G-group reduced into
    (BHKV, n, d) each."""
    BHG, n, d = shape
    nb = n // t.a.shape[-1]
    dk_blk = torch.einsum("rmij,rmid->rmjd", t.ds, t.q_blk) * scale
    dv_blk = torch.einsum("rmij,rmid->rmjd", t.a, t.do_blk)
    return tuple(_segment_add(blk, y_idx, nb).reshape(
        BHKV, BHG // BHKV, n, d).sum(1) for blk in (dk_blk, dv_blk))


def block_sparse_attention_bwd_ref(q, k, v, c, x_idx, y_idx, flags, key_mask,
                                   do, dr, *, scale: float, block_size: int):
    """Plain recompute backward: (dq, dk, dv), all fp32.

    Per pair: a = mask·exp(s − mt_x), ds = a ⊙ (do_x v_yᵀ + dr_x), then
    dq_x += ds k_y·scale, dk_y += dsᵀ q_x·scale (G-group reduced),
    dv_y += aᵀ do_x.
    """
    t = _bwd_terms(q, k, v, c, x_idx, y_idx, flags, key_mask, do, dr,
                   scale=scale, block_size=block_size)
    return (_dq_of(t, x_idx, q.shape, scale),
            *_dkv_of(t, y_idx, q.shape, k.shape[0], scale))


def block_sparse_attention_bwd_dq_ref(q, k, v, c, x_idx, y_idx, flags,
                                      key_mask, do, dr, *, scale: float,
                                      block_size: int):
    """The dq part of the plain backward alone (the dq kernel's twin)."""
    t = _bwd_terms(q, k, v, c, x_idx, y_idx, flags, key_mask, do, dr,
                   scale=scale, block_size=block_size)
    return _dq_of(t, x_idx, q.shape, scale)


def block_sparse_attention_bwd_dkv_ref(q, k, v, c, x_idx, y_idx, flags,
                                       key_mask, do, dr, *, scale: float,
                                       block_size: int):
    """The (dk, dv) part of the plain backward alone (the dk/dv kernel's
    twin)."""
    t = _bwd_terms(q, k, v, c, x_idx, y_idx, flags, key_mask, do, dr,
                   scale=scale, block_size=block_size)
    return _dkv_of(t, y_idx, q.shape, k.shape[0], scale)


# --------------------------------------------------------------------------- #
# CSR pair lists: one list per output tile
# --------------------------------------------------------------------------- #
class QueryPairs(NamedTuple):
    """Pairs of each BHG row stably sorted by query block (the reference's
    ``ops._prepare`` order); tile (r, x) owns ``[ptr[r, x], ptr[r, x+1])``.
    All (BHG, m) int32, ``ptr`` (BHG, nb + 1)."""

    x: torch.Tensor
    y: torch.Tensor
    flags: torch.Tensor
    ptr: torch.Tensor


class KeyPairs(NamedTuple):
    """Pairs of each KV head's G groups flattened and stably sorted by key
    block (``ops._prepare_kv`` order); ``rows`` is the owning BHG row. All
    (BHKV, G·m) int32, ``ptr`` (BHKV, nb + 1)."""

    rows: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    flags: torch.Tensor
    ptr: torch.Tensor


def _row_ptr(sorted_ids, nb: int):
    """Per-row CSR offsets of sorted block ids: bincount + cumsum."""
    R = sorted_ids.shape[0]
    counts = torch.zeros((R, nb), dtype=torch.int32, device=sorted_ids.device)
    counts.scatter_add_(1, sorted_ids.long(), torch.ones_like(sorted_ids,
                                                              dtype=torch.int32))
    zero = torch.zeros((R, 1), dtype=torch.int32, device=sorted_ids.device)
    return torch.cat([zero, torch.cumsum(counts, 1, dtype=torch.int32)], 1)


def group_by_query(x_idx, y_idx, flags, nb: int) -> QueryPairs:
    order = torch.argsort(x_idx, dim=-1, stable=True)
    xs, ys, fl = (torch.gather(t, 1, order).to(torch.int32).contiguous()
                  for t in (x_idx, y_idx, flags))
    return QueryPairs(xs, ys, fl, _row_ptr(xs, nb))


def group_by_key(x_idx, y_idx, flags, G: int, nb: int) -> KeyPairs:
    BHG, m = x_idx.shape
    BHKV = BHG // G
    rows = torch.arange(BHG, dtype=torch.int32, device=x_idx.device)[:, None]
    rows = rows.expand(BHG, m).reshape(BHKV, G * m)
    x2, y2, f2 = (t.reshape(BHKV, G * m) for t in (x_idx, y_idx, flags))
    order = torch.argsort(y2, dim=-1, stable=True)
    rows, x2, y2, f2 = (torch.gather(t, 1, order).to(torch.int32).contiguous()
                        for t in (rows, x2, y2, f2))
    return KeyPairs(rows, x2, y2, f2, _row_ptr(y2, nb))


# --------------------------------------------------------------------------- #
# what the tensor-core kernels are built for, and their plan
# --------------------------------------------------------------------------- #
def padded_dim(d: int) -> int:
    """The head dim as the kernels take it: the next multiple of 16."""
    return -(-d // 16) * 16


def check_shape(d: int, block_size: int) -> None:
    """Raise ValueError unless the kernels are built for (d, block_size)."""
    if (padded_dim(d), block_size) not in KERNEL_SHAPES:
        raise ValueError(
            f"(head dim, block size) ({d}, {block_size}) is not built for "
            "the kernels: they take (head dim padded to a multiple of 16, "
            "block size) in " + ", ".join(str(x) for x in KERNEL_SHAPES))


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def plane_row_bytes(D: int) -> int:
    """Bytes of a bf16 plane row in shared memory (``PlaneRow`` in
    ``csrc/sm90_mma.cuh``): D / 8 16-byte chunks, XOR-swizzled in place when
    that count is a power of two, else padded to an odd count (D = 80: ten
    chunks in a row of eleven)."""
    chunks = D // 8
    return 16 * (chunks if chunks & (chunks - 1) == 0 else chunks | 1)


def column_split(D: int) -> int:
    """Warps that share a 16-row slab (``col_split`` in the source): above
    D = 128 each owns 128 columns of the accumulators."""
    return D // 128 if D > 128 else 1


def kernel_plan(kernel: str, dtype, d: int, block_size: int) -> dict:
    """Geometry and dynamic shared memory of one block of the forward
    (``"fwd"``), dq (``"dq"``) or dk/dv (``"dkv"``) kernel; mirrors
    ``FwdGeo`` / ``DqGeo`` / ``DkvGeo`` in the source. ``rows``: the block's
    query (fwd, dq) or key (dkv) rows, 16 a slab of ``col_split`` warps;
    ``stage``: keys (fwd, dq) or queries (dkv) a ring stage."""
    check_shape(d, block_size)
    D, b = padded_dim(d), block_size
    terms = 1 if dtype == torch.bfloat16 else 3
    cs = column_split(D)
    wide = cs > 1  # q in planes, not registers; fp32 in 32-row blocks
    prb = plane_row_bytes(D)  # a plane row
    srow = prb if terms == 1 else D * 4  # a staged input row (bf16: a plane)
    rows = 32 if wide and terms > 1 else min(64, b)
    if kernel in ("fwd", "dq"):
        if not wide:
            stage = min(64 if terms == 1 else 32, b)
        else:
            stage = 16 if terms > 1 else (64 if kernel == "fwd" else 32)
        slot = _a16(2 * stage * srow + stage * 4)  # k, v, key mask
        planes = 2 * terms * stage * prb if terms > 1 else 0  # split k, v
        q_planes = terms * rows * prb if wide or (
            kernel == "dq" and terms > 1) else 0
        if kernel == "fwd":  # fp32 q rows, q planes
            rest = (rows * (D * 4 + 16) if terms > 1 else 0) + q_planes
        else:  # split do, q planes
            rest = 3 * rows * prb + q_planes
        smem = 2 * slot + planes + rest
    elif kernel == "dkv":
        stage = 16 if wide and terms > 1 else min(32, b)
        kv = 2 * terms * rows * prb  # k and v planes
        slot = _a16(stage * srow + stage * D * 4 + 2 * stage * 4)
        ring = max(2 * slot, 2 * rows * D * 4 if terms > 1 else 0)
        smem = kv + ring + 3 * stage * prb + (
            terms * stage * prb if terms > 1 else 0)  # split do (and q)
    else:
        raise ValueError(f"kernel must be one of {tuple(_KERNELS)}, got "
                         f"{kernel!r}")
    return {"threads": 2 * rows * cs, "rows": rows, "col_split": cs,
            "sub_tiles": b // rows, "stage": stage, "smem_bytes": smem}


def smem_bytes(kernel: str, dtype, d: int, block_size: int) -> int:
    """Dynamic shared memory of one block (``kernel_plan``)."""
    return kernel_plan(kernel, dtype, d, block_size)["smem_bytes"]


def planned_blocks_per_sm(kernel: str, dtype, d: int, block_size: int) -> int:
    """Blocks an SM holds by shared memory and threads alone (registers,
    which ptxas decides, can only lower it: ``blocks_per_sm`` asks the
    card)."""
    plan = kernel_plan(kernel, dtype, d, block_size)
    return min(_SM_SMEM // (plan["smem_bytes"] + _BLOCK_RESERVED),
               _SM_THREADS // plan["threads"], 32)


def launch_geometry(kernel: str, dtype, d: int, block_size: int,
                    tiles: int) -> dict:
    """The launch of ``tiles`` output tiles: a one-dimensional grid of one
    block per row sub-tile of each tile, with ``kernel_plan``'s block."""
    plan = kernel_plan(kernel, dtype, d, block_size)
    return {"grid": tiles * plan["sub_tiles"], **plan}


def blocks_per_sm(kernel: str, dtype, d: int, block_size: int) -> int:
    """Blocks of the kernel resident on one SM, from the card's occupancy
    API (registers as ptxas allocated them, threads, shared memory)."""
    check_shape(d, block_size)
    lib = _library()
    n = ctypes.c_int(0)
    rc = lib.bsa_blocks_per_sm(_KERNELS[kernel], _DTYPES[dtype],
                               padded_dim(d), block_size, ctypes.byref(n))
    _raise_on(rc, lib, f"bsa {kernel} occupancy")
    return n.value


def pairs_per_tile(ptr) -> torch.Tensor:
    """Pairs of each output tile, flattened: the CSR offsets' differences."""
    return (ptr[:, 1:] - ptr[:, :-1]).reshape(-1)


def tile_order(ptr) -> torch.Tensor:
    """Launch order of the output tiles of a CSR pair list: heaviest first
    (most pairs), ties in natural order, so the longest pair lists start in
    the first wave; a balanced selection keeps the natural order. Computed
    on the pairs' device, with no sync."""
    return torch.argsort(pairs_per_tile(ptr), descending=True,
                         stable=True).to(torch.int32)


# --------------------------------------------------------------------------- #
# CUDA launches
# --------------------------------------------------------------------------- #
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .build import load_library

    lib = load_library("block_sparse_attn")
    if lib.bsa_fwd_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bsa_fwd_launch.argtypes = [ptr] * 12 + [i32] * 6 + [f32, i32, ptr]
        lib.bsa_bwd_dq_launch.argtypes = [ptr] * 12 + [i32] * 6 + [f32, i32, ptr]
        lib.bsa_bwd_dkv_launch.argtypes = [ptr] * 14 + [i32] * 5 + [f32, i32, ptr]
        lib.bsa_blocks_per_sm.argtypes = [i32] * 4 + [ptr]
        lib.bsa_smem_bytes.argtypes = [i32] * 4
        lib.bsa_smem_bytes.restype = ctypes.c_longlong
        for fn in (lib.bsa_fwd_launch, lib.bsa_bwd_dq_launch,
                   lib.bsa_bwd_dkv_launch, lib.bsa_blocks_per_sm):
            fn.restype = i32
        lib.bsa_error_string.argtypes = [i32]
        lib.bsa_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_qkv(q, k, v, block_size):
    """(BHG, BHKV, n, d, device) after checking the shared inputs and that
    the kernels are built for their shape."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} must be "
                         "(rows, n, d)")
    BHG, n, d = q.shape
    BHKV = k.shape[0]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take tensors on the card, got {dev}")
    if BHKV == 0 or BHG % BHKV:
        raise ValueError(f"q rows {BHG} are not a multiple of k rows {BHKV}")
    if block_size <= 0 or n % block_size:
        raise ValueError(f"block size {block_size} must divide n = {n}")
    check_shape(d, block_size)
    _check(q, "q", (BHG, n, d), tuple(_DTYPES), dev)
    _check(k, "k", (BHKV, n, d), (q.dtype,), dev)
    _check(v, "v", (BHKV, n, d), (q.dtype,), dev)
    return BHG, BHKV, n, d, dev


def _raise_on(rc: int, lib, name: str):
    if rc != 0:
        msg = lib.bsa_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _pad_dim(*ts):
    """The tensors with their last dim zero-padded to ``padded_dim`` (exact
    for the kernels' products); as they are when it is built already."""
    d = ts[0].shape[-1]
    D = padded_dim(d)
    if D == d:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, D - d)) for t in ts)


def _unpad(d, *ts):
    return tuple(t if t.shape[-1] == d else t[..., :d].contiguous() for t in ts)


def bsa_fwd(q, k, v, c, pairs: QueryPairs, key_mask, *, scale: float,
            block_size: int):
    """Launch the forward kernel: (out (BHG,n,d), rowsum, mt (BHG,n)) fp32."""
    BHG, BHKV, n, d, dev = _check_qkv(q, k, v, block_size)
    nb, m = n // block_size, pairs.y.shape[1]
    i32 = (torch.int32,)
    _check(c, "c", (BHG, nb), (torch.float32,), dev)
    _check(pairs.ptr, "row_ptr", (BHG, nb + 1), i32, dev)
    _check(pairs.y, "y_idx", (BHG, m), i32, dev)
    _check(pairs.flags, "flags", (BHG, m), i32, dev)
    _check(key_mask, "key_mask", (BHKV, n), i32, dev)
    q, k, v = _pad_dim(q, k, v)
    D = q.shape[-1]
    order = tile_order(pairs.ptr)
    out = torch.empty((BHG, n, D), dtype=torch.float32, device=dev)
    rowsum = torch.empty((BHG, n), dtype=torch.float32, device=dev)
    mt = torch.empty((BHG, n), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.bsa_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), c.data_ptr(),
        pairs.ptr.data_ptr(), pairs.y.data_ptr(), pairs.flags.data_ptr(),
        key_mask.data_ptr(), order.data_ptr(), out.data_ptr(),
        rowsum.data_ptr(), mt.data_ptr(), BHG, BHG // BHKV, n, D, block_size,
        m, float(scale), _DTYPES[q.dtype], _stream(dev))
    _raise_on(rc, lib, "bsa_fwd")
    bsa_fwd.launches += 1
    return (*_unpad(d, out), rowsum, mt)


def bsa_bwd_dq(q, k, v, mt, do, dr, pairs: QueryPairs, key_mask, *,
               scale: float, block_size: int):
    """Launch the dq kernel: dq (BHG, n, d) fp32."""
    BHG, BHKV, n, d, dev = _check_qkv(q, k, v, block_size)
    nb, m = n // block_size, pairs.y.shape[1]
    i32, f32 = (torch.int32,), (torch.float32,)
    _check(mt, "mt", (BHG, n), f32, dev)
    _check(do, "do", (BHG, n, d), f32, dev)
    _check(dr, "dr", (BHG, n), f32, dev)
    _check(pairs.ptr, "row_ptr", (BHG, nb + 1), i32, dev)
    _check(pairs.y, "y_idx", (BHG, m), i32, dev)
    _check(pairs.flags, "flags", (BHG, m), i32, dev)
    _check(key_mask, "key_mask", (BHKV, n), i32, dev)
    q, k, v, do = _pad_dim(q, k, v, do)
    D = q.shape[-1]
    order = tile_order(pairs.ptr)
    dq = torch.empty((BHG, n, D), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.bsa_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mt.data_ptr(), do.data_ptr(),
        dr.data_ptr(), pairs.ptr.data_ptr(), pairs.y.data_ptr(),
        pairs.flags.data_ptr(), key_mask.data_ptr(), order.data_ptr(),
        dq.data_ptr(), BHG, BHG // BHKV, n, D, block_size, m, float(scale),
        _DTYPES[q.dtype], _stream(dev))
    _raise_on(rc, lib, "bsa_bwd_dq")
    bsa_bwd_dq.launches += 1
    return _unpad(d, dq)[0]


def bsa_bwd_dkv(q, k, v, mt, do, dr, pairs: KeyPairs, key_mask, *,
                scale: float, block_size: int):
    """Launch the dk/dv kernel: (dk, dv) (BHKV, n, d) fp32."""
    BHG, BHKV, n, d, dev = _check_qkv(q, k, v, block_size)
    nb, m2 = n // block_size, pairs.y.shape[1]
    i32, f32 = (torch.int32,), (torch.float32,)
    _check(mt, "mt", (BHG, n), f32, dev)
    _check(do, "do", (BHG, n, d), f32, dev)
    _check(dr, "dr", (BHG, n), f32, dev)
    _check(pairs.ptr, "row_ptr", (BHKV, nb + 1), i32, dev)
    for name in ("rows", "x", "flags"):
        _check(getattr(pairs, name), name, (BHKV, m2), i32, dev)
    _check(key_mask, "key_mask", (BHKV, n), i32, dev)
    q, k, v, do = _pad_dim(q, k, v, do)
    D = q.shape[-1]
    order = tile_order(pairs.ptr)
    dk = torch.empty((BHKV, n, D), dtype=torch.float32, device=dev)
    dv = torch.empty((BHKV, n, D), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.bsa_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mt.data_ptr(), do.data_ptr(),
        dr.data_ptr(), pairs.ptr.data_ptr(), pairs.rows.data_ptr(),
        pairs.x.data_ptr(), pairs.flags.data_ptr(), key_mask.data_ptr(),
        order.data_ptr(), dk.data_ptr(), dv.data_ptr(), BHKV, n, D,
        block_size, m2, float(scale), _DTYPES[q.dtype], _stream(dev))
    _raise_on(rc, lib, "bsa_bwd_dkv")
    bsa_bwd_dkv.launches += 1
    return _unpad(d, dk, dv)


bsa_fwd.launches = 0  # launches of each CUDA kernel, never reset here
bsa_bwd_dq.launches = 0
bsa_bwd_dkv.launches = 0


# --------------------------------------------------------------------------- #
# the meta route (the dry run)
# --------------------------------------------------------------------------- #
_PLAN = {"bsa_fwd": "fwd", "bsa_bwd_dq": "dq", "bsa_bwd_dkv": "dkv"}
SMS = 132  # the H100's SMs, for the meta route's plan


def _meta_record(name, q, k, m2, block_size):
    """Check and plan the launch of ``name`` on meta q / k as on the card
    and record its cost at the budget (every pair full); a shape not built
    is recorded in ``cost.LEDGER.unbuilt``."""
    BHG, n, d = q.shape
    BHKV = k.shape[0]
    b = block_size
    try:
        tiles = (BHKV if name == "bsa_bwd_dkv" else BHG) * (n // b)
        geo = launch_geometry(_PLAN[name], q.dtype, d, b, tiles)
        if geo["smem_bytes"] > _SM_SMEM - _BLOCK_RESERVED:
            raise ValueError(f"{name}: {geo['smem_bytes']} bytes of shared "
                             "memory")
    except ValueError:
        cost.LEDGER.refuse(name, (padded_dim(d), b))
        return
    key = f"q{tuple(q.shape)} kv{tuple(k.shape)} b={b}"
    cost.LEDGER.record(name, key, cost.bsa_cost(
        name, BHG, BHKV, n, padded_dim(d), b, m2, q.element_size(),
        full=BHG * m2))


def _meta_forward(q, k, c, x_idx, block_size):
    _meta_record("bsa_fwd", q, k, x_idx.shape[1], block_size)
    f32 = dict(dtype=torch.float32, device=q.device)
    BHG, n, d = q.shape
    return (torch.empty((BHG, n, d), **f32), torch.empty((BHG, n), **f32),
            torch.empty((BHG, n), **f32), None)


def _meta_backward(q, k, x_idx, block_size):
    for name in ("bsa_bwd_dq", "bsa_bwd_dkv"):
        _meta_record(name, q, k, x_idx.shape[1], block_size)
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(q.shape, **f32), torch.empty(k.shape, **f32),
            torch.empty(k.shape, **f32))


# --------------------------------------------------------------------------- #
# the autograd.Function
# --------------------------------------------------------------------------- #
def _forward(q, k, v, c, x_idx, y_idx, flags, key_mask, scale, block_size):
    """(out, rowsum, mt, pairs): the kernel for CUDA tensors, the plain
    version for CPU tensors, the meta route for meta ones. ``pairs`` is
    the ``QueryPairs`` the kernel walked, kept for the dq kernel (None on
    the CPU)."""
    if q.is_meta:
        return _meta_forward(q, k, c, x_idx, block_size)
    if not q.is_cuda:
        return (*block_sparse_attention_ref(q, k, v, x_idx, y_idx, flags, c,
                                            key_mask, scale=scale,
                                            block_size=block_size), None)
    pairs = group_by_query(x_idx, y_idx, flags, q.shape[1] // block_size)
    return (*bsa_fwd(q, k, v, c, pairs, key_mask, scale=scale,
                     block_size=block_size), pairs)


def _backward(q, k, v, c, mt, pairs, x_idx, y_idx, flags, key_mask, do, dr,
              scale, block_size):
    """(dq, dk, dv) fp32: the kernels for CUDA tensors, the plain version
    (which recomputes mt from c) for CPU tensors, the meta route for meta
    ones."""
    if q.is_meta:
        return _meta_backward(q, k, x_idx, block_size)
    if not q.is_cuda:
        return block_sparse_attention_bwd_ref(
            q, k, v, c, x_idx, y_idx, flags, key_mask, do, dr, scale=scale,
            block_size=block_size)
    nb = q.shape[1] // block_size
    G = q.shape[0] // k.shape[0]
    do = do.to(torch.float32).contiguous()
    dr = dr.to(torch.float32).contiguous()
    dq = bsa_bwd_dq(q, k, v, mt, do, dr, pairs, key_mask, scale=scale,
                    block_size=block_size)
    dk, dv = bsa_bwd_dkv(q, k, v, mt, do, dr,
                         group_by_key(x_idx, y_idx, flags, G, nb), key_mask,
                         scale=scale, block_size=block_size)
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, c, x_idx, y_idx, flags, key_mask, scale,
                block_size):
        out, rowsum, mt, pairs = _forward(q, k, v, c, x_idx, y_idx, flags,
                                          key_mask, scale, block_size)
        # saved tensors, so remat drops and recomputes the pair lists too
        ctx.save_for_backward(q, k, v, c, mt, x_idx, y_idx, flags, key_mask,
                              *(pairs if pairs is not None else (None,) * 4))
        ctx.scale, ctx.block_size = scale, block_size
        ctx.mark_non_differentiable(mt)
        return out, rowsum, mt

    @staticmethod
    def backward(ctx, do, dr, _dmt):  # mt's cotangent is dropped
        q, k, v, c, mt, x_idx, y_idx, flags, key_mask, *pq = ctx.saved_tensors
        pairs = None if pq[0] is None else QueryPairs(*pq)
        dq, dk, dv = _backward(q, k, v, c, mt, pairs, x_idx, y_idx, flags,
                               key_mask, do, dr, ctx.scale, ctx.block_size)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                torch.zeros_like(c),  # dc ≡ 0: the stabilizer is transparent
                None, None, None, None, None, None)


def block_sparse_attention(q, k, v, c, x_idx, y_idx, flags,
                           key_mask: Optional[torch.Tensor] = None, *,
                           scale: float = 1.0, block_size: int = 32):
    """Unnormalized block-sparse attention numerator, row sums, stabilizer.

    Args:
      q: (BHG, n, d); k/v: (BHKV, n, d) with BHG % BHKV == 0 (GQA groups);
        bf16 or fp32, all three alike.
      c: (BHG, nb) fp32 stabilizer floor per query block (the MRA-2 coarse
        background max, clamped above NEG_INF/2); dc ≡ 0 by contract.
      x_idx / y_idx: (BHG, m) int32 selected (query-block, key-block) pairs.
      flags: (BHG, m) int32 — bit0: pair is valid; bit1: causal triangular
        mask inside the block (diagonal blocks).
      key_mask: optional (BHKV, n) key validity (>0 = valid).
      scale: softmax scale; block_size: b.

    Returns:
      out (BHG, n, d), rowsum (BHG, n), mt (BHG, n), all fp32 — stabilized
      by exp(−mt); mt is not differentiable. Backward returns dq, dk, dv in
      the input dtypes and dc ≡ 0.
    """
    if key_mask is None:
        key_mask = torch.ones((k.shape[0], k.shape[1]), dtype=torch.int32,
                              device=k.device)
    return _BlockSparseAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        c.to(torch.float32).contiguous(), x_idx.to(torch.int32),
        y_idx.to(torch.int32), flags.to(torch.int32),
        key_mask.to(torch.int32).contiguous(), float(scale), int(block_size))
