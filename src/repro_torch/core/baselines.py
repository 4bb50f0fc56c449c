"""Efficient-attention baselines the paper compares against (§5).

Port of ``repro/core/baselines.py``. Each baseline is a function
``f(q, k, v, **kw) -> out`` with q / k / v (B, H, N, D) that approximates
``softmax(QK^T/sqrt(d)) V`` in the paper's approximation protocol (Fig.
4/5, Tab. 7); learned parameters (Linformer's E, Performer's features,
BigBird's random blocks) are fixed random draws, as in the reference.

Baselines: Linformer, Performer (FAVOR+), Nyströmformer, Longformer
(sliding window), BigBird (window + global + random blocks) and
H-Transformer-1D (MRA-2 with a banded budget, ``core/mra.py``; on the card
its exact term runs the block-sparse kernel, built for head dim 64 at
block 32).

Random draws. The reference draws with ``jax.random``; this package
cannot. Each function that draws takes its draw as a keyword (Linformer's
``E``, Performer's ``W``, BigBird's ``rand_idx``) and otherwise makes it
from a CPU ``torch.Generator`` seeded with ``seed``: the same seed gives the
same draw on every device, but not the reference's numbers (a different
generator; the Performer's chi-square norms are drawn as root sums of
squared normals, the reference's by a rejection sampler). Passing the
reference's draws gives the reference's function.
"""
from __future__ import annotations

from typing import Optional

import torch

from .mra import NEG_INF, MraConfig, block_mean, full_attention, mra2_attention


def _scale(d: int, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / (d**0.5)


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# --------------------------------------------------------------------------- #
# the draws (CPU generator, fp32)
# --------------------------------------------------------------------------- #
def linformer_projection(n: int, proj_dim: int = 64, seed: int = 0):
    """Linformer's fixed length projection E (n, proj_dim)."""
    E = torch.randn((n, proj_dim), generator=_generator(seed))
    return E / (proj_dim**0.5)


def performer_features(d: int, num_features: int = 64, seed: int = 0):
    """Performer's orthogonal random features W (num_features, d): rows of
    orthogonal blocks (the Q of a Gaussian matrix's QR, transposed), each
    row scaled by the root of a chi-square(d) draw."""
    g = _generator(seed)
    blocks = [torch.linalg.qr(torch.randn((d, d), generator=g))[0].T
              for _ in range(num_features // d + 1)]
    W = torch.cat(blocks, dim=0)[:num_features]
    norms = torch.sqrt(torch.sum(
        torch.randn((num_features, d), generator=g) ** 2, dim=-1))
    return W * norms[:, None]


def bigbird_random_blocks(nb: int, num_random: int = 3, seed: int = 0):
    """BigBird's random key blocks (nb, num_random), int64 in [0, nb)."""
    return torch.randint(0, nb, (nb, num_random), generator=_generator(seed))


# --------------------------------------------------------------------------- #
# Low-rank family
# --------------------------------------------------------------------------- #
def linformer_attention(q, k, v, *, proj_dim: int = 64, seed: int = 0,
                        softmax_scale=None, E=None):
    """Linformer (Wang et al., 2020): project the length axis of K/V to
    ``proj_dim``; ``E`` (N, proj_dim) overrides the seeded draw."""
    B, H, N, D = q.shape
    if E is None:
        E = linformer_projection(N, proj_dim, seed)
    E = torch.as_tensor(E, dtype=torch.float32).to(q.device)
    kp = torch.einsum("bhnd,nk->bhkd", k.float(), E)
    vp = torch.einsum("bhnd,nk->bhkd", v.float(), E)
    s = torch.einsum("bhid,bhkd->bhik", q.float(), kp) * _scale(D, softmax_scale)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhik,bhkd->bhid", p, vp).to(q.dtype)


def performer_attention(q, k, v, *, num_features: int = 64, seed: int = 0,
                        softmax_scale=None, W=None):
    """Performer FAVOR+ (Choromanski et al., 2021) positive random features;
    ``W`` (num_features, D) overrides the seeded draw."""
    B, H, N, D = q.shape
    sc = _scale(D, softmax_scale)
    if W is None:
        W = performer_features(D, num_features, seed)
    W = torch.as_tensor(W, dtype=torch.float32).to(q.device)

    def phi(x):
        x = x.float() * (sc**0.5)
        proj = torch.einsum("bhnd,md->bhnm", x, W)
        sq = 0.5 * torch.sum(x * x, dim=-1, keepdim=True)
        return (torch.exp(proj - sq - proj.amax(-1, keepdim=True))
                / (num_features**0.5))

    qf, kf = phi(q), phi(k)
    kv = torch.einsum("bhnm,bhnd->bhmd", kf, v.float())
    z = 1.0 / (torch.einsum("bhnm,bhm->bhn", qf, kf.sum(2)) + 1e-9)
    return (torch.einsum("bhnm,bhmd->bhnd", qf, kv) * z[..., None]).to(q.dtype)


def nystromformer_attention(q, k, v, *, num_landmarks: int = 32,
                            pinv_iters: int = 6, softmax_scale=None):
    """Nystromformer (Xiong et al., 2021): landmark Nystrom approximation."""
    B, H, N, D = q.shape
    sc = _scale(D, softmax_scale)
    lm = num_landmarks
    if N % lm:
        raise ValueError(f"length {N} not divisible by {lm} landmarks")
    qf, kf = q.float(), k.float()
    q_l = block_mean(qf, N // lm)  # (B,H,lm,D) segment-mean landmarks
    k_l = block_mean(kf, N // lm)
    f = torch.softmax(torch.einsum("bhid,bhjd->bhij", qf, k_l) * sc, dim=-1)
    a = torch.softmax(torch.einsum("bhid,bhjd->bhij", q_l, k_l) * sc, dim=-1)
    bmat = torch.softmax(torch.einsum("bhid,bhjd->bhij", q_l, kf) * sc, dim=-1)
    # iterative Moore-Penrose pseudo-inverse (Razavi et al.)
    z = a.transpose(-1, -2) / (
        a.abs().sum(-2).amax(-1)[..., None, None]
        * a.abs().sum(-1).amax(-1)[..., None, None])
    eye = torch.eye(lm, dtype=torch.float32, device=q.device)
    for _ in range(pinv_iters):
        az = a @ z
        z = 0.25 * z @ (13 * eye - az @ (15 * eye - az @ (7 * eye - az)))
    out = f @ (z @ (bmat @ v.float()))
    return out.to(q.dtype)


# --------------------------------------------------------------------------- #
# Sparsity family
# --------------------------------------------------------------------------- #
def _band(qf, kb, vb, sc, *, dist_mask: bool):
    """Scores and values of the three-block band: each query block against
    its own key block and its two neighbours (rolled; out-of-range
    neighbours masked), optionally with Longformer's |i - j| <= w/2 mask.
    qf / kb / vb (B, H, nb, w, D)."""
    nb, w = qf.shape[2], qf.shape[3]
    dev = qf.device
    blocks = torch.arange(nb, device=dev)
    scores, vals = [], []
    for shift in (-1, 0, 1):
        kk = torch.roll(kb, -shift, dims=2)
        vv = torch.roll(vb, -shift, dims=2)
        ok = ((blocks + shift >= 0) & (blocks + shift < nb))[None, None, :,
                                                             None, None]
        s = torch.einsum("bhnid,bhnjd->bhnij", qf, kk) * sc
        if dist_mask:
            qi = torch.arange(w, device=dev)[:, None]
            kj = torch.arange(w, device=dev)[None, :] + shift * w
            ok = ok & ((qi - kj).abs() <= w // 2)[None, None, None]
        scores.append(torch.where(ok, s, NEG_INF))
        vals.append(vv)
    return scores, vals


def longformer_attention(q, k, v, *, window: int = 64, num_global: int = 0,
                         softmax_scale=None):
    """Longformer (Beltagy et al., 2020): sliding window + optional global
    tokens, as banded attention over shifted key blocks. O(n * window)."""
    B, H, N, D = q.shape
    sc = _scale(D, softmax_scale)
    w = window
    if N % w:
        raise ValueError(f"length {N} not divisible by window {w}")
    nb = N // w
    qf = q.reshape(B, H, nb, w, D).float()
    kf, vf = k.float(), v.float()
    scores, vals = _band(qf, kf.reshape(B, H, nb, w, D),
                         vf.reshape(B, H, nb, w, D), sc, dist_mask=True)
    s_all = torch.cat(scores, dim=-1)  # (B,H,nb,w,3w)
    v_all = torch.cat(vals, dim=-2)  # (B,H,nb,3w,D)
    if num_global > 0:
        sg = torch.einsum("bhnid,bhjd->bhnij", qf, kf[:, :, :num_global]) * sc
        s_all = torch.cat([s_all, sg], dim=-1)
        v_all = torch.cat([v_all, vf[:, :, None, :num_global].expand(
            B, H, nb, num_global, D)], dim=-2)
    p = torch.softmax(s_all, dim=-1)
    out = torch.einsum("bhnij,bhnjd->bhnid", p, v_all)
    return out.reshape(B, H, N, D).to(q.dtype)


def bigbird_attention(q, k, v, *, window: int = 64, num_global: int = 16,
                      num_random: int = 3, seed: int = 0, softmax_scale=None,
                      rand_idx=None):
    """BigBird (Zaheer et al., 2020): window + global + random block
    attention; ``rand_idx`` (nb, num_random) overrides the seeded draw."""
    B, H, N, D = q.shape
    sc = _scale(D, softmax_scale)
    w = window
    if N % w:
        raise ValueError(f"length {N} not divisible by window {w}")
    nb = N // w
    qf = q.reshape(B, H, nb, w, D).float()
    kb = k.reshape(B, H, nb, w, D).float()
    vb = v.reshape(B, H, nb, w, D).float()
    scores, vals = _band(qf, kb, vb, sc, dist_mask=False)
    if rand_idx is None:
        rand_idx = bigbird_random_blocks(nb, num_random, seed)
    flat = torch.as_tensor(rand_idx).long().to(q.device).reshape(-1)
    kr = kb[:, :, flat].reshape(B, H, nb, num_random * w, D)
    vr = vb[:, :, flat].reshape(B, H, nb, num_random * w, D)
    scores.append(torch.einsum("bhnid,bhnjd->bhnij", qf, kr) * sc)
    vals.append(vr)
    if num_global > 0:  # global prefix tokens
        kg = k[:, :, :num_global].float()
        vg = v[:, :, :num_global].float()
        scores.append(torch.einsum("bhnid,bhjd->bhnij", qf, kg) * sc)
        vals.append(vg[:, :, None].expand(B, H, nb, num_global, D))
    p = torch.softmax(torch.cat(scores, dim=-1), dim=-1)
    out = torch.einsum("bhnij,bhnjd->bhnid", p, torch.cat(vals, dim=-2))
    return out.reshape(B, H, N, D).to(q.dtype)


def h_transformer_1d_attention(q, k, v, *, block: int = 32, levels: int = 2,
                               softmax_scale=None):
    """H-Transformer-1D (Zhu & Soricut, 2021) as MRA with a banded budget.

    Exact attention on a tri-diagonal budget of blocks (the diagonal forced),
    the rest at the coarse scale: the reference keeps MRA-2's data-dependent
    selection with the banded budget, which upper-bounds H1D fidelity (paper
    Fig. 5). ``levels`` is accepted and, as in the reference, not read."""
    cfg = MraConfig(block_size=block, blocks_per_row=3, variant="full",
                    force_diagonal=True, softmax_scale=softmax_scale)
    return mra2_attention(q, k, v, cfg)


def _full(q, k, v, **kw):
    return full_attention(q, k, v, softmax_scale=kw.get("softmax_scale"))


REGISTRY = {
    "linformer": linformer_attention,
    "performer": performer_attention,
    "nystromformer": nystromformer_attention,
    "longformer": longformer_attention,
    "bigbird": bigbird_attention,
    "h_transformer_1d": h_transformer_1d_attention,
    "full": _full,
}
