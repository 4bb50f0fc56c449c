"""Training loop on one device: microbatches, AdamW, fault tolerance.

Port of ``repro/train/loop.py`` for one card:
  * the model from the registry (``get_model(cfg)``): the dense and MoE
    families (the MoE layers' aux losses in the loss), the hubert encoder,
    the internvl VLM, the rwkv6 recurrent LM and the recurrentgemma
    hybrid, each batch key (tokens, frames, mask positions,
    patches, targets) on the device; ``tokens_per_s`` counts the positions
    a step trains (``batch_positions``: tokens, hubert's frames, internvl's
    patches plus text tokens);
  * gradient accumulation over microbatches in fp32, or with
    ``grad_compression="bf16_ef"`` in bf16 with an fp32 error-feedback
    residual carried across the microbatches (``optim/compression.py``);
  * the config's remat policy (``cfg.remat``: none, full or dots), AdamW +
    cosine schedule with global-norm clipping;
  * checkpoints every ``ckpt_every`` steps (the parameters through the
    ``AsyncCheckpointer``, then the optimizer state) and resume from the
    newest one in ``ckpt_dir``; the data stream is keyed by the step, so a
    resumed run is bit-identical to an uninterrupted one;
  * preemption: SIGTERM checkpoints at the next step boundary and ends the
    loop; straggler flagging: a step slower than ``straggler_factor`` times
    the EWMA of step times is logged.

The MRA-2 attention of every layer runs the block-sparse kernels on the
card (``kernels/block_sparse_attn.py``), recurrentgemma's local layers too
when its attention kind is MRA-2; rwkv6, the RG-LRU layers and the exact
``local`` kind run plain PyTorch, as their reference is plain jnp. Meshes
and sharded attention are
not ported (ROADMAP module item 6) and raise.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.data import DataLoader
from repro_torch.models.params import init_params, tree_leaves, tree_unflatten
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW, compress, cosine_schedule, init_ef

GRAD_COMPRESSION = ("none", "bf16_ef")


def batch_positions(batch) -> int:
    """Sequence positions of a batch: B·S of its frames, or of its tokens
    plus its patches."""
    if "frames" in batch:
        return int(batch["frames"].shape[0] * batch["frames"].shape[1])
    n = batch["tokens"].numel()
    if "patches" in batch:
        n += batch["patches"].shape[0] * batch["patches"].shape[1]
    return int(n)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    microbatches: int = 1
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    grad_compression: str = "none"  # none | bf16_ef
    log_every: int = 10
    straggler_factor: float = 2.0  # steps slower than EWMA*factor are flagged
    mesh_shape: Optional[Tuple[int, int]] = None  # not ported: one device
    shard_attention: Optional[bool] = None  # not ported


def _check_ported(tc: TrainConfig) -> None:
    if tc.grad_compression not in GRAD_COMPRESSION:
        raise ValueError(f"grad_compression={tc.grad_compression!r}: "
                         f"expected one of {GRAD_COMPRESSION}")
    if tc.mesh_shape is not None or tc.shard_attention:
        raise NotImplementedError(
            "meshes and sharded attention come with the distributed slice "
            "(ROADMAP module item 6); the port trains on one device")


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: AdamW,
                    lr_fn: Callable):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` leaves must require grad; they and the optimizer state are
    updated in place. ``batch`` holds the family's tensors (``make_batch``)
    on the params' device; B must divide by ``tc.microbatches``.
    """
    _check_ported(tc)
    model = get_model(cfg)
    ef = tc.grad_compression == "bf16_ef"

    def one(params, leaves, mb):
        loss, metrics = model.loss_fn(params, cfg, mb)
        grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def grads_and_metrics(params, batch):
        leaves = tree_leaves(params)
        if tc.microbatches == 1:
            return one(params, leaves, batch)
        M = tc.microbatches
        acc_dtype = torch.bfloat16 if ef else torch.float32
        acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
               for p in leaves]
        res = init_ef(leaves) if ef else None
        met = None
        for i in range(M):
            mb = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]
                  for k, v in batch.items()}
            grads, metrics = one(params, leaves, mb)
            if ef:  # the reference's scan body: bf16 sums, fp32 residual
                grads, res = compress(list(grads), res)
            for a, g in zip(acc, grads):
                a.add_(g.to(acc_dtype))
            met = metrics if met is None else {k: met[k] + metrics[k]
                                               for k in met}
        return ([a.to(torch.float32) / M for a in acc],
                {k: v / M for k, v in met.items()})

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

    # preemption: SIGTERM checkpoints at the end of the running step, then
    # the loop ends
    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True

    old_term = signal.signal(signal.SIGTERM, _handler)
    ckpter = AsyncCheckpointer()
    loader = DataLoader(cfg, shape, seed=tc.seed, start_step=start_step)
    ewma = None
    metrics = {}
    try:
        for step in range(start_step, tc.steps):
            _, batch = next(loader)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            params, opt_state, out = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in out.items()}  # waits
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > tc.straggler_factor * ewma and step > start_step + 3:
                print(f"[straggler] step {step} took {dt:.3f}s "
                      f"(ewma {ewma:.3f}s)")
            metrics["step_time_s"] = dt
            metrics["tokens_per_s"] = batch_positions(batch) / dt
            if on_metrics:
                on_metrics(step, metrics)
            if step % tc.log_every == 0:
                unit = ("frames" if "frames" in batch else "patches+text"
                        if "patches" in batch else "tokens")
                print(f"step {step}: loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms "
                      f"{metrics['tokens_per_s']:.0f} {unit}/s")
            if tc.ckpt_dir and ((step + 1) % tc.ckpt_every == 0
                                or preempted["flag"]):
                ckpter.save(tc.ckpt_dir, step + 1, params)
                ckpter.wait()
                save(tc.ckpt_dir + "/opt", step + 1, opt_state)
            if preempted["flag"]:
                print(f"[preempt] checkpointed at step {step + 1}; exiting")
                break
    finally:
        loader.close()
        ckpter.wait()
        signal.signal(signal.SIGTERM, old_term)
    return params, opt_state, metrics
