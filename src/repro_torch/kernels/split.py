"""The plain version of the kernels' split-operand arithmetic.

The tensor-core kernels (``csrc/chunk_attn.cu``, ``csrc/block_sparse_attn.cu``)
take fp32 accuracy from bf16 products: an fp32 operand is split into three
bf16 terms that sum to it exactly (``split3`` in ``csrc/sm90_mma.cuh``), and
a product keeps the term products i + j <= 2, smallest first. These two
functions do the same on tensors, so that tests on the CPU can hold the
scheme to the reference arithmetic; nothing on the main path calls them.
"""
from __future__ import annotations

import torch


def bf16_terms(x: torch.Tensor):
    """x as three bf16 terms, largest first, as the kernels split an fp32
    operand: (t0 + t1) + t2 == x exactly for normal fp32."""
    t0 = x.to(torch.bfloat16)
    r = x - t0.float()
    t1 = r.to(torch.bfloat16)
    return t0, t1, (r - t1.float()).to(torch.bfloat16)


def operand_terms(x: torch.Tensor):
    """The bf16 terms the kernels feed to the tensor cores for an operand:
    a bf16 tensor as it is, an fp32 one as its three terms."""
    return (x,) if x.dtype == torch.bfloat16 else bf16_terms(x.float())


def term_products(a_terms, b_terms) -> torch.Tensor:
    """Σ a_i @ b_j over the term products with i + j <= 2, smallest first,
    each product and the sum in fp32 (the kernels' mma_terms)."""
    out = None
    for L in (2, 1, 0):
        for j, b in enumerate(b_terms):
            i = L - j
            if 0 <= i < len(a_terms):
                p = a_terms[i].float() @ b.float()
                out = p if out is None else out + p
    return out
