"""Operations and bytes of each kernel's call, and the H100's rates.

The least time a call could take on the card is the larger of the bytes it
must move (each input read once, each output written once) over the HBM
rate and its operations over the peak rate of their type. The formulas
here are the ones ``chip_smoke.py`` prints beside each kernel's time
(PERF.md §6's bound column) and the ones the dry run (``launch/dryrun.py``)
adds to its matmul count, so both count the same work.

Where the work depends on the data (the pairs a selection made, the pages
a tile's rows select), ``chip_smoke.py`` passes what its inputs need. The
dry run has no data, and counts the budget: every pair of a block-sparse
row full (b² scores; a causal diagonal pair needs b(b+1)/2), every row of
a serving tile its m pages of b keys, and a tile's rows a union of
min(nb, rows·m) pages.

``LEDGER`` is what the kernel wrappers' meta route writes: per kernel, the
calls, operations and bytes of the meta calls since ``LEDGER.reset()``,
the (shape) keys they launched at, and the shapes no kernel is built for.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet (dense rates, no sparsity, at its 700 W
# power limit) and NVIDIA's NDR InfiniBand / NVLink 4 specifications
BF16_FLOP_PER_S = 989.4e12   # bf16 tensor cores
FP32_FLOP_PER_S = 66.9e12    # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
HBM_BYTES = 80e9             # device memory
NVLINK_BYTES_PER_S = 450e9   # a direction, to the other cards of a node
IB_BYTES_PER_S = 50e9        # NDR 400 Gb/s InfiniBand, one NIC a GPU
GPUS_PER_NODE = 8


def bound_ms(nbytes: float, flops: float, rate: float = BF16_FLOP_PER_S):
    """(least ms, "bytes" | "operations") of a call at ``rate`` FLOP/s."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------------- #
# the block-sparse training kernels (csrc/block_sparse_attn.cu)
# --------------------------------------------------------------------------- #
# products of a score entry: fwd q·k and p·v; dq also do·v; dk/dv also the
# two outer products; the backward pair (dq + dk/dv) the five distinct ones
BSA_PRODUCTS = {"bsa_fwd": 2, "bsa_bwd_dq": 3, "bsa_bwd_dkv": 4,
                "bwd_pair": 5}


def bsa_cost(kernel: str, BHG: int, BHKV: int, n: int, d: int, b: int,
             m2: int, elem: int, full: int, diag: int = 0) -> dict:
    """One block-sparse call: q (BHG, n, d) against k / v (BHKV, n, d) of
    ``elem`` bytes an entry, m2 pairs a row (their lists: three int32 a
    pair, a row pointer a query block), ``full`` valid pairs of b² scores
    and ``diag`` causal diagonal ones of b(b+1)/2. Outputs: fwd the
    numerator, row sums and mt (fp32), its input c; the backward reads do,
    dr and mt and writes dq, dk / dv (fp32)."""
    nb = n // b
    lists = 3 * BHG * m2 * 4 + BHG * (nb + 1) * 4
    bwd_in = lists + BHG * n * (d + 2) * 4  # pair lists, do, dr, mt
    extra = {"bsa_fwd": BHG * nb * 4 + lists + BHG * n * (d + 2) * 4,
             "bsa_bwd_dq": bwd_in + BHG * n * d * 4,
             "bsa_bwd_dkv": bwd_in + 2 * BHKV * n * d * 4,
             "bwd_pair": bwd_in + (BHG + 2 * BHKV) * n * d * 4}[kernel]
    entries = full * b * b + diag * b * (b + 1) // 2
    nbytes = (BHG * n * d * elem + 2 * BHKV * n * d * elem + BHKV * n * 4
              + extra)
    return {"bytes": nbytes, "flops": 2 * BSA_PRODUCTS[kernel] * entries * d,
            "full_pairs": full, "diagonal_pairs": diag}


# --------------------------------------------------------------------------- #
# the serving kernel (csrc/chunk_attn.cu)
# --------------------------------------------------------------------------- #
def chunk_cost(B: int, Hkv: int, G: int, C: int, D: int, b: int, nb: int,
               elem: int, quant: bool, union: int, pairs: int,
               nu: int = 0) -> dict:
    """One chunk/decode call: ``union`` K/V pages read (pages selected by
    at least one row of a (B·Hkv) row's tiles, each b keys of D entries of
    ``elem`` bytes, with per-token fp32 scales when ``quant``), the fp32
    page means and counts, queries, positions, the output, and ``nu``
    collapsed entries of the H-level program. Operations: coarse scores
    and background 2·2·rows·nb·D, the exact term 2·2·pairs·D over the
    (query row, key) pairs attended, the H-level scores and fold
    2·2·rows·nu·D."""
    page = b * D * elem + (b * 4 if quant else 0)
    rows = B * Hkv * G * C
    nbytes = (2 * union * page                 # selected K/V pages (+scales)
              + 2 * B * Hkv * nb * D * 4       # page means k_ds, v_ds
              + 2 * B * nb * 4                 # counts, page table
              + rows * D * 4 + B * C * 4       # queries, positions
              + rows * D * 4                   # output
              + 2 * B * Hkv * nu * D * 4 + B * nu * 4)  # hk, hv, hcnt
    flops = (2 * 2 * rows * nb * D + 2 * 2 * pairs * D
             + 2 * 2 * rows * nu * D)
    return {"bytes": nbytes, "flops": flops}


def chunk_budget(B: int, Hkv: int, G: int, C: int, b: int, nb: int, m: int,
                 c_tile: int) -> tuple:
    """(union pages, pairs) at the selection budget: each row m pages of b
    keys, a tile's G·c_tile rows at most min(nb, rows·m) pages."""
    tiles = -(-C // c_tile)
    union = B * Hkv * tiles * min(nb, G * min(c_tile, C) * m)
    pairs = B * Hkv * G * C * min(m, nb) * b
    return union, pairs


# --------------------------------------------------------------------------- #
# the meta route's record
# --------------------------------------------------------------------------- #
class KernelLedger:
    """Kernel calls made on meta tensors: per kernel name its calls,
    operations, bytes and launch keys; the shapes not built."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.kernels: dict = {}
        self.unbuilt: set = set()

    def record(self, name: str, key: str, cost: dict) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0, "shapes": {}})
        k["calls"] += 1
        k["flops"] += cost["flops"]
        k["bytes"] += cost["bytes"]
        k["shapes"][key] = k["shapes"].get(key, 0) + 1

    def refuse(self, name: str, shape) -> None:
        self.unbuilt.add(f"{name} {tuple(shape)}")

    def snapshot(self) -> dict:
        return {"kernels": {k: dict(v, shapes=dict(v["shapes"]))
                            for k, v in sorted(self.kernels.items())},
                "kernels_unbuilt": sorted(self.unbuilt)}


LEDGER = KernelLedger()
