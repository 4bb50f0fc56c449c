"""Quickstart: MRA-2 attention as a drop-in function.

Port of the reference's ``examples/quickstart.py``: the paper's MRA-2
against exact softmax attention on random GQA inputs, the budget sweep of
the paper's Tab. 7, the model-facing dispatch, and the block-sparse
kernel route against its plain twin (on the card: the CUDA kernel; on the
CPU both routes are the plain twin).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from unittest import mock

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.attention import AttentionSpec, self_attention
from repro_torch.core.mra import MraConfig, full_attention, mra2_attention
from repro_torch.kernels import block_sparse_attn as bsa


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def run(device=None, N: int = 1024) -> dict:
    """The quickstart's numbers: ``rel_error`` of MRA-2 (b = 32, 4 blocks a
    row), ``sweep`` {blocks a row: (entries kept, rel error)}, the
    dispatch's output shape and the kernel route's max |diff|."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    B, Hq, Hkv, D = 2, 8, 2, 64  # GQA: 8 query heads share 2 KV heads

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(
            torch.bfloat16).to(dev)

    q, k, v = draw(B, Hq, N, D), draw(B, Hkv, N, D), draw(B, Hkv, N, D)
    out = {}
    ref = full_attention(q, k, v)
    cfg = MraConfig(block_size=32, blocks_per_row=4)
    out["rel_error"] = _rel(mra2_attention(q, k, v, cfg), ref)
    print(f"MRA-2 (b=32, 4 blocks/row)  rel error vs softmax: "
          f"{out['rel_error']:.4f}")
    out["sweep"] = {}
    for bpr in (1, 2, 8, 16):
        c = MraConfig(block_size=32, blocks_per_row=bpr)
        e = _rel(mra2_attention(q, k, v, c), ref)
        frac = c.budget(N) * 32 * 32 / (N * N)
        out["sweep"][bpr] = (frac, e)
        print(f"  blocks/row={bpr:>2}  entries kept={frac:5.1%}  rel err={e:.4f}")
    spec = AttentionSpec(kind="mra2", block_size=32, blocks_per_row=4)
    o2 = self_attention(q, k, v, spec, causal=True)
    out["dispatch"] = (tuple(o2.shape), str(o2.dtype))
    print("dispatch (causal mra2):", tuple(o2.shape), o2.dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    got = mra2_attention(qf, kf, vf, cfg)
    before = bsa.bsa_fwd.launches
    with mock.patch.object(bsa, "_forward", _plain_forward):
        plain = mra2_attention(qf, kf, vf, cfg)
    out["kernel_diff"] = float((got - plain).abs().max())
    out["kernel_launches"] = bsa.bsa_fwd.launches - before
    print(f"kernel path max |diff| vs plain path: {out['kernel_diff']:.3e} "
          f"({'CUDA kernel' if dev.type == 'cuda' else 'plain twin on the CPU'})")
    return out


def _plain_forward(q, k, v, c, x_idx, y_idx, flags, key_mask, scale,
                   block_size):
    return (*bsa.block_sparse_attention_ref(
        q, k, v, x_idx, y_idx, flags, c, key_mask, scale=scale,
        block_size=block_size), None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
