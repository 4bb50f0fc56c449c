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
``local`` kind run plain PyTorch, as their reference is plain jnp.

Meshes (``TrainConfig.mesh_shape`` or ``train(..., mesh=)``, each rank of
the process group calling ``train`` alike): the parameters are the rank's
blocks (``distributed/sharding.py``), the batch its rows over the data
axis (``batch_pspec``), and the layers split their work over "model"
(``models/layers.py``, ``models/moe.py``), so attention runs on the rank's
(batch, kv-head) block by construction. The gradients are
averaged over the data axis, the global norm counts each replicated leaf
once, the moments are ZeRO-1 shards (``optim/adamw.zero_plan``), and a
checkpoint holds whole tensors, so ``restore`` re-shards it onto whatever
mesh the relaunch has. Every family trains under a mesh: rwkv6 splits its
time-mix heads and channel-mix d_ff over "model", recurrentgemma its MLP
and vocab, with the RG-LRU and the one-KV-head attention on the rank's
rows (``models/rwkv6.py``, ``models/recurrentgemma.py``).
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
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh_utils
from repro_torch.distributed.sharding import (
    batch_pspec,
    local_block,
    param_placements,
)
from repro_torch.models.params import init_params, tree_leaves, tree_unflatten
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW, compress, cosine_schedule, init_ef
from repro_torch.optim.adamw import AdamWState, tree_leaves_pspec, zero_plan

# gradient elements per all-reduce over the data axis
_BUCKET = 1 << 25

GRAD_COMPRESSION = ("none", "bf16_ef")


def opt_placements(params, placements, plan):
    """The placement tree of an ``AdamWState`` under ``plan``: the step
    replicated, each moment its parameter's placement plus the ZeRO-1 data
    split."""
    pl = tree_leaves_pspec(placements)
    zp = [ps if dim is None else tuple("data" if i == dim else part
                                       for i, part in enumerate(ps))
          for ps, dim in zip(pl, plan.dims)]
    moments = tree_unflatten(params, zp)
    return AdamWState((), moments, moments)


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
    # a (data, model) mesh over the process group's ranks when ``train()``
    # is not handed one (None: one device)
    mesh_shape: Optional[Tuple[int, int]] = None


def _check_ported(tc: TrainConfig) -> None:
    if tc.grad_compression not in GRAD_COMPRESSION:
        raise ValueError(f"grad_compression={tc.grad_compression!r}: "
                         f"expected one of {GRAD_COMPRESSION}")


def data_mean(tensors, mesh) -> list:
    """Each tensor averaged over the data axis **in place**, in fp32
    buckets of at most ``_BUCKET`` elements (one all-reduce each): no
    second copy of the gradients is held. Returns the tensors."""
    tensors = list(tensors)
    if C.axis_size(mesh, "data") == 1:
        return tensors
    bucket, n = [], 0

    def flush():
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in bucket])
        flat = C.all_reduce(flat, mesh, "data", "mean")
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view(t.shape))

    # a contiguous tensor larger than a bucket goes in pieces (views of its
    # storage), so no all-reduce, nor a copy of one, passes _BUCKET elements
    pieces = [p for t in tensors for p in
              (t.view(-1).split(_BUCKET) if t.is_contiguous() else (t,))]
    for t in pieces:
        if bucket and n + t.numel() > _BUCKET:
            flush()
            bucket, n = [], 0
        bucket.append(t)
        n += t.numel()
    if bucket:
        flush()
    return tensors


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: AdamW,
                    lr_fn: Callable, *, mesh=None, plan=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` leaves must require grad; they and the optimizer state are
    updated in place. ``batch`` holds the family's tensors (``make_batch``)
    on the params' device; B must divide by ``tc.microbatches``. Under
    ``mesh`` the params are the rank's blocks, the batch its rows, the
    optimizer state follows ``plan`` (``optim.adamw.zero_plan``), and the
    gradients and metrics are averaged over the data axis.
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
        with mesh_utils.use_mesh(mesh):
            grads, metrics = grads_and_metrics(params, batch)
        if C.axis_size(mesh, "data") > 1:
            grads = data_mean(grads, mesh)
            keys = sorted(metrics)
            vals = data_mean([torch.stack([metrics[k].float()
                                           for k in keys])], mesh)[0]
            metrics = dict(zip(keys, vals.unbind()))
        lr = lr_fn(opt_state.step)
        params, opt_state, gnorm = optimizer.update(
            tree_unflatten(params, grads), opt_state, params, lr,
            plan=plan)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def train(cfg: ModelConfig, shape: ShapeCfg, tc: TrainConfig, *, device=None,
          mesh=None, on_metrics=None):
    """Init or restore -> loop -> checkpoint. Returns (params, opt_state,
    last metrics). ``on_metrics(step, metrics)`` sees each step's floats.

    Under a mesh (``mesh``, else ``tc.mesh_shape`` over the process group)
    every rank calls ``train`` alike and gets its own blocks back, with the
    same metrics."""
    _check_ported(tc)
    dev = resolve_device(device)
    if mesh is None and tc.mesh_shape is not None:
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(*tc.mesh_shape, device=dev)
    optimizer = AdamW()
    params = init_params(cfg, seed=tc.seed, device=dev, mesh=mesh)
    placements = plan = opt_places = None
    if mesh is not None:
        placements = param_placements(cfg, mesh)
        plan = zero_plan(params, placements, mesh)
        opt_places = opt_placements(params, placements, plan)
        dp = C.axis_size(mesh, "data")
        if shape.global_batch % dp:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"divide the data axis of {dp}")
    step_fn = make_train_step(cfg, tc, optimizer,
                              cosine_schedule(tc.lr, tc.warmup, tc.steps),
                              mesh=mesh, plan=plan)
    opt_state = optimizer.init(params, plan)
    start_step = 0
    if tc.ckpt_dir:
        last = latest_step(tc.ckpt_dir)
        if last is not None:
            params = restore(tc.ckpt_dir, last, params, mesh=mesh,
                             placements=placements)
            opt_state = restore(tc.ckpt_dir + "/opt", last, opt_state,
                                mesh=mesh, placements=opt_places)
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
            if mesh is not None:  # the rank's rows
                batch = {k: local_block(torch.from_numpy(v),
                                        batch_pspec(mesh, v.ndim), mesh)
                         for k, v in batch.items()}
                batch = {k: v.to(dev) for k, v in batch.items()}
            else:
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
            t0 = time.perf_counter()
            params, opt_state, out = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in out.items()}  # waits
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > tc.straggler_factor * ewma and step > start_step + 3:
                print(f"[straggler] step {step} took {dt:.3f}s "
                      f"(ewma {ewma:.3f}s)")
            metrics["step_time_s"] = dt
            metrics["tokens_per_s"] = (
                batch_positions(batch) * C.axis_size(mesh, "data") / dt)
            if on_metrics:
                on_metrics(step, metrics)
            if step % tc.log_every == 0:
                unit = ("frames" if "frames" in batch else "patches+text"
                        if "patches" in batch else "tokens")
                print(f"step {step}: loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms "
                      f"{metrics['tokens_per_s']:.0f} {unit}/s")
            if mesh is not None and C.axis_size(mesh, "data") * C.axis_size(
                    mesh, "model") > 1:  # every rank stops at the same step
                flag = torch.tensor(float(preempted["flag"]), device=dev)
                preempted["flag"] = bool(
                    C.all_reduce(C.all_reduce(flag, mesh, "data", "max"),
                                 mesh, "model", "max"))
            if tc.ckpt_dir and ((step + 1) % tc.ckpt_every == 0
                                or preempted["flag"]):
                ckpter.save(tc.ckpt_dir, step + 1, params, mesh=mesh,
                            placements=placements)
                ckpter.wait()
                save(tc.ckpt_dir + "/opt", step + 1, opt_state, mesh=mesh,
                     placements=opt_places)
            if preempted["flag"]:
                print(f"[preempt] checkpointed at step {step + 1}; exiting")
                break
    finally:
        loader.close()
        ckpter.wait()
        signal.signal(signal.SIGTERM, old_term)
    return params, opt_state, metrics
