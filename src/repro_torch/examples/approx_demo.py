"""The paper's Fig. 1 narrative: MRA vs low rank vs sparsity.

Port of the reference's ``examples/approx_demo.py``: a representative
(structured) attention matrix approximated three ways at the same 10%
budget, the error comparison the paper opens with (MRA 0.30 / low rank
1.24 / sparse 0.39 on its example). The scores are drawn with numpy from
the seed, as the reference's ``benchmarks/approx_error.py`` draws them (the
port keeps its own copy), and the approximations are computed in float64
on the device.

    PYTHONPATH=src python -m repro_torch.examples.approx_demo
    PYTHONPATH=src python -m repro_torch.examples.approx_demo --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device


def fig1_scores(rng, N=512, sharp=3.0):
    """Representative attention scores: a sharp banded diagonal of varying
    width, a few global key columns, contiguous content clusters, token
    noise (the reference's ``fig1_scores``, same draws)."""
    i = np.arange(N)[:, None]
    j = np.arange(N)[None, :]
    w = 8 + 24 * (0.5 + 0.5 * np.sin(2 * np.pi * i / N * 3))
    P = 1.5 * np.exp(-((i - j).astype(np.float64) ** 2) / (2 * w**2))
    for g in rng.integers(0, N, 6):
        P[:, g] += 0.7 + 0.2 * rng.standard_normal()
    nclust = 10
    bounds = np.sort(rng.integers(0, N, nclust - 1))
    bounds = np.r_[0, bounds, N]
    cid = np.zeros(N, int)
    for c in range(nclust):
        cid[bounds[c]:bounds[c + 1]] = c
    P += 0.3 * rng.standard_normal((nclust, nclust))[cid[:, None], cid[None, :]]
    P += 0.2 * rng.standard_normal((N, N))
    return P * sharp


def fig1_matrix_level(rng, N=512, keep=0.10, block=32, device=None):
    """(MRA, SVD, Nystrom, sparse) relative Frobenius errors on A = exp(P)
    at a shared 10% budget (the reference's ``fig1_matrix_level``): SVD is
    the optimal low rank, Nystrom the realizable one, top-entry sparsity an
    O(n²) oracle."""
    dev = resolve_device(device)
    P = fig1_scores(rng, N)
    P = torch.from_numpy(P - P.max()).to(dev)
    A = torch.exp(P)
    fro = torch.linalg.norm(A)
    nb = N // block
    m = max(int(keep * N * N / (block * block)), 1)
    mu = torch.exp(P.reshape(nb, block, nb, block).mean((1, 3)))  # coarse mu
    order = torch.flip(torch.argsort(mu.reshape(-1), stable=True), (0,))
    A_mra = mu.repeat_interleave(block, 0).repeat_interleave(block, 1)
    keep_blk = torch.zeros(nb * nb, dtype=torch.bool, device=dev)
    keep_blk[order[:m]] = True
    fine = keep_blk.reshape(nb, nb).repeat_interleave(
        block, 0).repeat_interleave(block, 1)
    A_mra = torch.where(fine, A, A_mra)
    err_mra = torch.linalg.norm(A_mra - A) / fro

    r = max(int(keep * N), 1)
    U, S, Vt = torch.linalg.svd(A, full_matrices=False)
    err_svd = torch.linalg.norm((U[:, :r] * S[:r]) @ Vt[:r] - A) / fro

    cols = torch.from_numpy(rng.choice(N, r, replace=False)).to(dev)
    C = A[:, cols]
    W = A[cols][:, cols]
    A_nys = C @ torch.linalg.pinv(W, rtol=1e-8) @ A[cols, :]
    err_nys = torch.linalg.norm(A_nys - A) / fro

    kth = torch.topk(A.reshape(-1), int(keep * N * N)).values[-1]
    err_sp = torch.linalg.norm(torch.where(A >= kth, A, 0.0) - A) / fro
    return tuple(float(e) for e in (err_mra, err_svd, err_nys, err_sp))


def run(device=None, seeds: int = 5) -> dict:
    print("budget = keep 10% of {MRA block entries | ranks | nonzeros}\n")
    print(f"{'seed':>4} {'MRA':>8} {'SVD(opt)':>9} {'Nystrom':>9} {'sparse*':>8}")
    errs = []
    for seed in range(seeds):
        e = fig1_matrix_level(np.random.default_rng(seed), device=device)
        errs.append(e)
        print(f"{seed:>4} {e[0]:8.3f} {e[1]:9.3f} {e[2]:9.3f} {e[3]:8.3f}")
    mean = np.mean(errs, axis=0)
    print(f"{'mean':>4} {mean[0]:8.3f} {mean[1]:9.3f} {mean[2]:9.3f} "
          f"{mean[3]:8.3f}")
    print("\npaper Fig. 1: MRA 0.30, low-rank 1.24, sparse 0.39")
    print("(* top-entry sparsity is an O(n^2) oracle, not a practical method;")
    print("   SVD is the optimal low-rank bound; Nystrom is the realizable one)")
    print("claim check — MRA < practical low-rank:", bool(mean[0] < mean[2]))
    print("claim check — MRA < optimal SVD:       ", bool(mean[0] < mean[1]))
    return {"errors": errs, "mean": mean.tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args(argv)
    return run(args.device, args.seeds)


if __name__ == "__main__":
    main()
