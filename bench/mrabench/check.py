"""What decides ``correct``: the plain reference (``mrabench.reference``)
against what the timed path produced, after the window has closed and the
program's state is freed.

Serving: a sample of the window's finished requests drawn from the seed,
the request with the longest prompt always among them, of at least
``check.served_tokens`` served tokens. The reference runs once over each
prompt with its served tokens. Each served token reads the gap by which
its logit lies below the reference's best at its position; the mean gap
over the sample is compared, and so is the count of served tokens whose
gap passes the configuration's ``tail_gap``: one wrong token, which the
mean over some hundreds would hide, reads a gap of some logits there
(``altered_token_gap_least`` in the notes: the least gap of the token
one id above each served one). The widest gap is reported beside them.

Training: the reference runs the window's first ``checked_steps`` steps
from the same weights and batches. Compared: the first step's pre-clip
global gradient norm; each leaf's first clipped gradient norm (from the
second moment after step one) and each leaf's change after the last
checked step, these two by the worst leaf: the gap between the program's
norm and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf; and the worst step's loss gap where the
configuration gives it a limit. Each step's loss and norm gaps are
reported. Leaves whose first gradient is under a thousandth of the median
leaf's in the reference are left out of the leaf numbers.

With ``ctx.control`` the same reference in float8 e4m3 stands in for the
program as well, and its readings are reported beside the program's.
"""
from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

from . import weights
from .clock import now
from .reference.decoder import Cast, Decoder
from .reference.mra_serve import served_logits
from .reference.train import AdamW, first_grad_norms, loss


@contextlib.contextmanager
def float32():
    """Float32 products without TF32, restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def sample(served: list, seed: int, tokens: int) -> list:
    """The request with the longest prompt, then others in an order drawn
    from the seed, until ``tokens`` served tokens are in."""
    if not served:
        return []
    order = sorted(range(len(served)), key=lambda i: -len(served[i][0]))
    rest = np.random.default_rng(
        np.random.SeedSequence([int(seed), 4])).permutation(order[1:])
    out, n = [], 0
    for i in [order[0], *rest.tolist()]:
        out.append(served[i])
        n += len(served[i][1])
        if n >= tokens:
            break
    return out


@torch.no_grad()
def serve(ctx) -> None:
    t0 = now()
    model, dev = ctx.model, ctx.device
    att = model["attention"]
    b = att["block_size"]
    m = min(att["decode_blocks"], ctx.traffic["engine"]["max_len"] // b)
    picked = sample(ctx.served, ctx.seed,
                    ctx.traffic["check"]["served_tokens"])
    params, _ = weights.make(model, ctx.seed, dev)
    gaps, altered, ctrl_gaps = [], [], []
    with float32():
        dec = Decoder(model, params)
        ctrl = Decoder(model, params, Cast("fp8")) if ctx.control else None
        for prompt, out in picked:
            toks = torch.from_numpy(np.concatenate([prompt, out[:-1]])
                                    ).to(dev, torch.int64)
            at = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                              device=dev)
            served = torch.from_numpy(out).to(dev, torch.int64)[:, None]
            ref = served_logits(dec, toks, at, block=b, m=m)
            best = ref.amax(-1)
            gaps += (best - ref.gather(-1, served)[:, 0]).tolist()
            other = (served + 1) % model["vocab"]
            altered += (best - ref.gather(-1, other)[:, 0]).tolist()
            if ctrl is not None:
                pick = served_logits(ctrl, toks, at, block=b, m=m).argmax(-1)
                ctrl_gaps += (best - ref.gather(-1, pick[:, None])[:, 0]
                              ).tolist()
                del pick
            del ref, best
    ctx.notes["check_s"] = now() - t0
    ctx.notes["checked_requests"] = len(picked)
    ctx.notes["checked_tokens"] = len(gaps)
    lim, tail = ctx.limits, ctx.spec["config"]["tail_gap"]
    if not gaps:
        ctx.compare("served_logit_gap_mean", float("inf"),
                    lim["served_logit_gap_mean"])
        return
    ctx.notes["served_logit_gap_widest"] = max(gaps)
    ctx.notes["altered_token_gap_least"] = min(altered)
    ctx.compare("served_logit_gap_mean", sum(gaps) / len(gaps),
                lim["served_logit_gap_mean"])
    ctx.compare("served_tokens_over_tail_gap", sum(g > tail for g in gaps),
                lim["served_tokens_over_tail_gap"])
    if ctrl is not None:
        ctx.control_readings.update(
            served_logit_gap_mean=sum(ctrl_gaps) / len(ctrl_gaps),
            served_logit_gap_widest=max(ctrl_gaps),
            served_tokens_over_tail_gap=sum(g > tail for g in ctrl_gaps))


def _leaf_gap(prog, ref, keep) -> float:
    med = statistics.median(r for r, k in zip(ref, keep) if k)
    return max(abs(p - r) / max(r, med)
               for p, r, k in zip(prog, ref, keep) if k)


def reference_steps(ctx, cast: Cast) -> dict:
    """The reference's readings over the first checked steps."""
    model, t, dev, seed = ctx.model, ctx.traffic, ctx.device, ctx.seed
    from .train import batch

    o = t["optimizer"]
    params, stacks = weights.make(model, seed, dev)
    named = list(weights.leaf_paths(params))
    leaves = [p.requires_grad_(True) for _, p in named]
    dec = Decoder(model, params, cast)
    opt = AdamW(o["b1"], o["b2"], o["eps"], o["weight_decay"],
                o["clip_norm"])
    state = opt.init(leaves)
    losses, gnorms = [], []
    with float32():
        for i in range(int(t["checked_steps"])):
            bt = batch(t, model["vocab"], seed, i, dev)
            total, mean = loss(dec, bt["tokens"], bt["targets"])
            grads = torch.autograd.grad(total, leaves)
            del total
            gnorms.append(float(opt.update(leaves, grads, state,
                                           float(o["lr"]))))
            losses.append(float(mean.detach()))
            del grads, mean
            if i == 0:
                grad1 = first_grad_norms(state["nu"], o["b2"]).tolist()
    del state
    change = weights.by_name(*weights.change_norms(model, seed, stacks),
                             [n for n, _ in named])
    return dict(loss=losses, grad_norm=gnorms, grad1=grad1, change=change)


def train(ctx) -> None:
    t0 = now()
    prog = ctx.program_readings
    ref = reference_steps(ctx, Cast())
    ctx.free()
    ctx.notes["check_s"] = now() - t0
    _train_compare(ctx, prog, ref, ctx.compare)
    if ctx.control:
        ctrl = reference_steps(ctx, Cast("fp8"))
        ctx.free()
        _train_compare(ctx, ctrl, ref,
                       lambda k, v, _: ctx.control_readings.__setitem__(k, v))


def _train_compare(ctx, prog, ref, put) -> None:
    """The first step's gradient norm is compared, and the leaf numbers;
    the worst step's loss gap where the configuration gives it a limit
    (where a fault separated it from sound runs). Each step's loss and
    norm gaps are reported (``loss_gap_by_step``); the later steps'
    gradient norms are not compared: sign flips of near-zero gradients
    under Adam amplify their gaps."""
    lim = ctx.limits
    med = statistics.median(ref["grad1"])
    keep = [g >= 1e-3 * med for g in ref["grad1"]]
    loss_gaps = [abs(a - b) for a, b in zip(prog["loss"], ref["loss"])]
    norm_gaps = [abs(a - b) / b for a, b in zip(prog["grad_norm"],
                                                ref["grad_norm"])]
    if put == ctx.compare:
        ctx.notes["leaves_compared"] = sum(keep)
        ctx.notes["leaves_left_out"] = len(keep) - sum(keep)
        ctx.notes["loss_gap_by_step"] = loss_gaps
        ctx.notes["grad_norm_gap_by_step"] = norm_gaps
    else:
        ctx.control_readings["loss_gap_by_step"] = loss_gaps
        ctx.control_readings["grad_norm_gap_by_step"] = norm_gaps
    if "loss_gap_worst_step" in lim:
        put("loss_gap_worst_step", max(loss_gaps), lim["loss_gap_worst_step"])
    put("grad_norm_gap_step1", norm_gaps[0], lim["grad_norm_gap_step1"])
    put("grad1_leaf_gap", _leaf_gap(prog["grad1"], ref["grad1"], keep),
        lim["grad1_leaf_gap"])
    put("change_leaf_gap", _leaf_gap(prog["change"], ref["change"], keep),
        lim["change_leaf_gap"])
