"""Training loop on one device: microbatch accumulation, AdamW, checkpoints.

Port of ``repro/train/loop.py`` for one card:
  * gradient accumulation over microbatches in fp32;
  * the config's remat policy (``cfg.remat``), AdamW + cosine schedule with
    global-norm clipping;
  * checkpoint every ``ckpt_every`` steps and resume from the newest one in
    ``ckpt_dir``; the data stream is keyed by the step, so a resumed run
    is bit-identical to an uninterrupted one.

The MRA-2 attention of every layer runs the block-sparse kernels on the
card (``kernels/block_sparse_attn.py``). Not ported yet (ROADMAP item 13):
bf16 gradient compression, meshes and sharded attention, which raise; the
asynchronous checkpointer, SIGTERM preemption and straggler flagging.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.data import DataLoader
from repro_torch.models import transformer
from repro_torch.models.params import init_params, tree_leaves, tree_unflatten
from repro_torch.optim import AdamW, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    microbatches: int = 1
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    grad_compression: str = "none"  # only "none" is ported
    log_every: int = 10
    mesh_shape: Optional[Tuple[int, int]] = None  # not ported: one device
    shard_attention: Optional[bool] = None  # not ported


def _check_ported(tc: TrainConfig) -> None:
    if tc.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={tc.grad_compression!r}: bf16 error-feedback "
            "compression comes with the distributed slice (ROADMAP item 13)")
    if tc.mesh_shape is not None or tc.shard_attention:
        raise NotImplementedError(
            "meshes and sharded attention come with the distributed slice "
            "(ROADMAP item 13); the port trains on one device")


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: AdamW,
                    lr_fn: Callable):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` leaves must require grad; they and the optimizer state are
    updated in place. ``batch`` holds (B, S) int tensors on the params'
    device; B must divide by ``tc.microbatches``.
    """
    _check_ported(tc)

    def one(params, leaves, mb):
        loss, metrics = transformer.loss_fn(params, cfg, mb)
        grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def grads_and_metrics(params, batch):
        leaves = tree_leaves(params)
        if tc.microbatches == 1:
            return one(params, leaves, batch)
        M = tc.microbatches
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        met = None
        for i in range(M):
            mb = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]
                  for k, v in batch.items()}
            grads, metrics = one(params, leaves, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
            met = metrics if met is None else {k: met[k] + metrics[k]
                                               for k in met}
        return ([a / M for a in acc], {k: v / M for k, v in met.items()})

    def train_step(params, opt_state, batch):
        grads, metrics = grads_and_metrics(params, batch)
        lr = lr_fn(opt_state.step)
        params, opt_state, gnorm = optimizer.update(
            tree_unflatten(params, grads), opt_state, params, lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def train(cfg: ModelConfig, shape: ShapeCfg, tc: TrainConfig, *, device=None,
          on_metrics=None):
    """Init or restore -> loop -> checkpoint. Returns (params, opt_state,
    last metrics). ``on_metrics(step, metrics)`` sees each step's floats."""
    _check_ported(tc)
    dev = resolve_device(device)
    optimizer = AdamW()
    step_fn = make_train_step(cfg, tc, optimizer,
                              cosine_schedule(tc.lr, tc.warmup, tc.steps))
    params = init_params(cfg, seed=tc.seed, device=dev)
    opt_state = optimizer.init(params)
    start_step = 0
    if tc.ckpt_dir:
        last = latest_step(tc.ckpt_dir)
        if last is not None:
            params = restore(tc.ckpt_dir, last, params)
            opt_state = restore(tc.ckpt_dir + "/opt", last, opt_state)
            start_step = last
    for p in tree_leaves(params):
        p.requires_grad_(True)

    loader = DataLoader(cfg, shape, seed=tc.seed, start_step=start_step)
    metrics = {}
    for step in range(start_step, tc.steps):
        _, batch = next(loader)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        params, opt_state, out = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in out.items()}  # waits for the step
        dt = time.perf_counter() - t0
        metrics["step_time_s"] = dt
        if on_metrics:
            on_metrics(step, metrics)
        if step % tc.log_every == 0:
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms")
        if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            save(tc.ckpt_dir, step + 1, params)
            save(tc.ckpt_dir + "/opt", step + 1, opt_state)
    return params, opt_state, metrics
