"""A training cell: the program's step function (``make_train_step``, what
``train()`` runs) on synthetic LM batches.

Set-up draws the weights, builds the optimizer state and the step, and
drives that step through ``warmup_steps`` steps on rows of their own (this
builds the kernels and warms every shape). It then starts the same step
object over from the seed: the weights are drawn again into the same
tensors and the moments zeroed in place. The window runs that object step
after step until ``seconds`` have passed, and at least ``checked_steps``
steps; its first steps are the checked ones. Their losses and gradient
norms, each leaf's first clipped gradient norm (from the second moment
after the window's first step) and each leaf's change after the last
checked step are queued on the device as the window runs and read once it
has closed. The plain reference then runs those steps from the same
weights and batches (``check.train``).
"""
from __future__ import annotations

import torch

from . import traffic as gen
from . import weights, work
from .clock import now
from .reference.train import first_grad_norms


def batch(t: dict, vocab: int, seed: int, step: int, device,
          warmup: bool = False) -> dict:
    toks = torch.from_numpy(gen.train_batch(t, vocab, seed, step, warmup))
    toks = toks.to(device=device, dtype=torch.int64)
    return {"tokens": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous()}


@torch.no_grad()
def start_over(model: dict, seed: int, stacks: list, state):
    """The step's weights and moments as the seed first made them, in the
    same tensors: the weights drawn again, the moments zeroed."""
    weights.redraw(model, seed, stacks)
    for tree in (state.mu, state.nu):
        for _, m in weights.leaf_paths(tree):
            m.zero_()
    return state._replace(step=0)


def run(ctx) -> None:
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.loop import TrainConfig, make_train_step

    t, model, dev, seed = ctx.traffic, ctx.model, ctx.device, ctx.seed
    o = t["optimizer"]
    params, stacks = weights.make(model, seed, dev)
    leaves = list(weights.leaf_paths(params))
    for _, p in leaves:
        p.requires_grad_(True)
    opt = AdamW(b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    lr = float(o["lr"])
    step_fn = make_train_step(ctx.cfg, TrainConfig(lr=lr, microbatches=1),
                              opt, lambda step: lr)
    state = opt.init(params)
    vocab = model["vocab"]
    for i in range(int(t["warmup_steps"])):
        params, state, out = step_fn(params, state,
                                     batch(t, vocab, seed, i, dev, True))
        out["loss"].item()
    state = start_over(model, seed, stacks, state)
    ctx.sync()

    first = int(t["checked_steps"])
    tokens_per_step = t["batch"] * t["seq_len"]
    losses, gnorms = [], []
    steps = 0
    ctx.window_start()
    with ctx.traced():
        t0 = now()
        while steps < first or now() - t0 < ctx.seconds:
            params, state, out = step_fn(params, state,
                                         batch(t, vocab, seed, steps, dev))
            loss = out["loss"].item()
            if steps < first:
                losses.append(loss)
                gnorms.append(out["grad_norm"].detach().clone())
            if steps == 0:
                grad1 = first_grad_norms(
                    [nu for _, nu in weights.leaf_paths(state.nu)], o["b2"])
            if steps == first - 1:
                change = weights.change_norms(model, seed, stacks)
            steps += 1
        ctx.sync()
        window_s = now() - t0
    ctx.window_end()
    names = [n for n, _ in leaves]
    ctx.program_readings = dict(
        loss=losses, grad_norm=[float(g) for g in gnorms],
        grad1=grad1.tolist(), change=weights.by_name(*change, names),
        names=names)
    ctx.attempted, ctx.failed = steps, 0
    ctx.window_s = window_s
    ctx.notes.update(steps=steps, tokens=steps * tokens_per_step)
    ctx.e2e["train_tok_s"] = steps * tokens_per_step / window_s
    ctx.layer_inputs.update(model_flops=3.0 * steps * t["batch"]
                            * work.train_sequence_flops(model, t["seq_len"]))
    ctx.read_memory_peak()
    del params, state, step_fn, leaves, stacks, out, grad1, change, gnorms
    ctx.free()
    from .check import train as check_train

    check_train(ctx)
