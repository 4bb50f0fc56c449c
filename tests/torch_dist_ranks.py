"""Rank programs of the distributed parity tests (tests/test_torch_dist_*.py).

Each test file spawns one process group (``repro_torch.launch.mesh.spawn``,
gloo on the CPU) and runs ``run_cases`` on every rank: the cases in order,
each on the mesh it names, returning numpy results by case name. The JAX
references are computed in the parent test process; this module imports
``torch``, ``numpy`` and ``repro_torch`` only, so the ranks never load JAX.
Inputs arrive as numpy arrays (the weights from the reference's init).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.attention import (
    AttentionSpec,
    chunk_attention,
    decode_attention,
    self_attention,
)
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh_utils
from repro_torch.distributed.sharding import (
    attention_partition,
    attention_pspec,
    batch_pspec,
    local_block,
    param_placements,
    shard_params,
)
from repro_torch.launch.mesh import make_local_mesh, parse_mesh
from repro_torch.models import transformer as TT
from repro_torch.models.moe import moe_block
from repro_torch.models.params import params_from_jax, tree_leaves
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import zero_plan


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _attn_block(mesh, a, parts, heads=True):
    return local_block(_t(a), attention_pspec(parts, np.ndim(a), heads=heads),
                       mesh).to(mesh.device)


def _launches():
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels import chunk_attn

    return {"bsa_fwd": bsa.bsa_fwd.launches,
            "bsa_bwd_dq": bsa.bsa_bwd_dq.launches,
            "bsa_bwd_dkv": bsa.bsa_bwd_dkv.launches,
            "chunk_attn": chunk_attn.chunk_attention_kernel.launches}


def case_attention(mesh_shape, q, k, v, masks, block_size, blocks_per_row,
                   device="cpu"):
    """MRA-2 self-attention on the rank's (batch, kv-head) block: the output
    and the gradients of sum(tanh(out)) for causal x each key mask (on a
    card: the block-sparse kernels, launches counted)."""
    mesh = make_local_mesh(*mesh_shape, device=device)
    before = _launches()
    parts = attention_partition(mesh, q.shape[0], k.shape[1])
    spec = AttentionSpec(kind="mra2", block_size=block_size,
                         blocks_per_row=blocks_per_row)
    out = []
    for causal in (False, True):
        for km in masks:
            ql, kl, vl = (_attn_block(mesh, x, parts).clone().requires_grad_()
                          for x in (q, k, v))
            kml = _attn_block(mesh, km, parts, heads=False)
            with mesh_utils.use_mesh(mesh):
                o = self_attention(ql, kl, vl, spec, causal=causal,
                                   key_mask=kml)
            grads = torch.autograd.grad(torch.tanh(o).sum(), (ql, kl, vl))
            out.append((_np(o), [_np(g) for g in grads]))
    after = _launches()
    return {"parts": parts, "out": out,
            "launches": {k: after[k] - before[k] for k in after}}


def case_kv_routes(mesh_shape, k, v, q, q1, lengths, q_pos, lengths_ring, pb,
                   kq, ks, vq, vs, block_size, decode_blocks, device="cpu"):
    """Chunk and decode attention over the rank's block of the decode state
    (a ring page table and int8 scales riding along), in both kernel
    modes (on a card: the chunk kernel, launches counted)."""
    mesh = make_local_mesh(*mesh_shape, device=device)
    before = _launches()
    parts = attention_partition(mesh, k.shape[0], k.shape[1])
    blk = {name: _attn_block(mesh, a, parts) for name, a in
           (("k", k), ("v", v), ("q", q), ("q1", q1), ("kq", kq),
            ("vq", vq), ("ks", ks), ("vs", vs))}
    rows = {name: _attn_block(mesh, a, parts, heads=False) for name, a in
            (("lengths", lengths), ("q_pos", q_pos),
             ("lengths_ring", lengths_ring), ("pb", pb))}
    out = {}
    with mesh_utils.use_mesh(mesh):
        for mode in ("latency", "throughput"):
            spec = AttentionSpec(kind="mra2", block_size=block_size,
                                 decode_blocks=decode_blocks,
                                 kernel_mode=mode)
            c = chunk_attention(blk["q"], blk["k"], blk["v"], rows["lengths"],
                                rows["q_pos"], spec)
            d = decode_attention(blk["q1"], blk["kq"], blk["vq"],
                                 rows["lengths_ring"], spec,
                                 page_blocks=rows["pb"], k_scale=blk["ks"],
                                 v_scale=blk["vs"])
            out[mode] = (_np(c), _np(d))
    after = _launches()
    return {"parts": parts, "out": out,
            "launches": {k: after[k] - before[k] for k in after}}


def _smoke(arch, overrides):
    return get_smoke_config(arch, **overrides)


def _blocks(tree):
    return [_np(x) for x in tree_leaves(tree)]


def case_train_step(mesh_shape, arch, overrides, weights, batch, lr):
    """Forward logits (the rank's rows), loss, gradient blocks averaged
    over the data axis, and one ZeRO-1 train step's parameter blocks, grad
    norm and loss."""
    from repro_torch.train.loop import TrainConfig, make_train_step

    mesh = make_local_mesh(*mesh_shape, device="cpu")
    cfg = _smoke(arch, overrides)
    params = shard_params(params_from_jax(weights, cfg, device="cpu"), cfg,
                          mesh)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    rows = {k: local_block(_t(v), batch_pspec(mesh, v.ndim), mesh)
            for k, v in batch.items()}
    model = get_model(cfg)
    with mesh_utils.use_mesh(mesh):
        with torch.no_grad():
            logits, _ = model.forward(params, cfg, {
                k: v for k, v in rows.items() if k != "targets"})
        loss, _ = model.loss_fn(params, cfg, rows)
        grads = torch.autograd.grad(loss, tree_leaves(params))
    from repro_torch.train.loop import data_mean

    grads = data_mean(grads, mesh)
    loss = data_mean([loss.detach()], mesh)[0]
    opt = AdamW()
    plan = zero_plan(params, param_placements(cfg, mesh), mesh)
    step = make_train_step(cfg, TrainConfig(), opt,
                           cosine_schedule(lr, 1, 10), mesh=mesh, plan=plan)
    state = opt.init(params, plan)
    params, state, metrics = step(params, state, rows)
    return {"logits": _np(logits), "loss": float(loss),
            "grads": [_np(g) for g in grads], "params": _blocks(params),
            "moment_shapes": [tuple(m.shape) for m in tree_leaves(state.mu)],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def case_moe(mesh_shape, arch, overrides, weights, x):
    """One MoE layer on the rank's rows and weight blocks: output, aux
    losses, and the gradients of sum(out ** 2) w.r.t. x and the weights."""
    mesh = make_local_mesh(*mesh_shape, device="cpu")
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.moe import moe_specs

    cfg = _smoke(arch, overrides)
    p = shard_tree({k: _t(v) for k, v in weights.items()}, moe_specs(cfg),
                   mesh)
    for t in p.values():
        t.requires_grad_(True)
    xl = local_block(_t(x), batch_pspec(mesh, 3), mesh).clone()
    xl.requires_grad_(True)
    with mesh_utils.use_mesh(mesh):
        out, aux = moe_block(xl, p, cfg)
    leaves = [xl] + [p[k] for k in sorted(p)]
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    return {"out": _np(out),
            "aux": {k: float(v.detach()) for k, v in aux.items()},
            "grads": [_np(g) for g in grads], "comm": C.STATS.snapshot()}


def case_data_mean(mesh_shape, sizes, bucket):
    """``train.loop.data_mean`` with ``_BUCKET`` set to ``bucket``: a
    contiguous tensor of each size in ``sizes`` and a transposed (not
    contiguous) one, each (data index + 1) times its arange, averaged in
    place; the results and the all-reduce calls it made."""
    from unittest import mock

    from repro_torch.train import loop

    mesh = make_local_mesh(*mesh_shape, device="cpu")
    f = mesh.index("data") + 1.0
    ts = [torch.arange(float(n)) * f for n in sizes]
    ts.append((torch.arange(12.0).reshape(3, 4) * f).t())
    C.STATS.reset()
    with mock.patch.object(loop, "_BUCKET", bucket):
        out = loop.data_mean(ts, mesh)
    return {"same": all(a is b for a, b in zip(out, ts)),
            "values": [_np(t) for t in ts],
            "calls": C.STATS.snapshot()["ops"]["all_reduce"]["calls"]}


def case_elastic(mesh_a, mesh_b, arch, overrides, shape, ckpt_dir, steps):
    """``train()`` for ``steps - 1`` steps on mesh A with a checkpoint at
    the end, then relaunched on mesh B for the last step (restore
    re-shards); the restored blocks and both runs' metrics."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models.params import init_params
    from repro_torch.train import TrainConfig, train

    cfg = _smoke(arch, overrides)
    shp = ShapeCfg(*shape)
    seen = {}

    def log(name):
        def on(step, metrics):
            seen.setdefault(name, {})[step] = metrics
        return on

    tc = TrainConfig(steps=steps - 1, ckpt_dir=ckpt_dir, ckpt_every=steps - 1,
                     warmup=1, lr=1e-3, log_every=100)
    train(cfg, shp, tc, device="cpu", mesh=make_local_mesh(*mesh_a,
                                                           device="cpu"),
          on_metrics=log("a"))
    mesh = parse_mesh("x".join(map(str, mesh_b)), device="cpu")
    assert mesh.shape == {"data": mesh_b[0], "model": mesh_b[1]}
    like = init_params(cfg, seed=1, device="cpu", mesh=mesh)
    restored = restore(ckpt_dir, latest_step(ckpt_dir), like, mesh=mesh,
                       placements=param_placements(cfg, mesh))
    tc = tc.__class__(**{**tc.__dict__, "steps": steps})
    train(cfg, shp, tc, device="cpu", mesh=mesh, on_metrics=log("b"))
    return {"restored": _blocks(restored), "metrics": seen}


def case_serve(mesh_shape, arch, overrides, weights, steps_tokens, chunks,
               slots, max_len):
    """decode_step over the rank's block of a fresh cache (the rank's rows
    in, every slot's logits gathered back, as the engine calls it), then
    prefill_chunk of two ragged chunks on another."""
    mesh = make_local_mesh(*mesh_shape, device="cpu")
    cfg = _smoke(arch, overrides)
    params = shard_params(params_from_jax(weights, cfg, device="cpu"), cfg,
                          mesh)
    from repro_torch.serve.cache import RingPagedKVCache

    out = {"decode": [], "chunk": []}
    with mesh_utils.use_mesh(mesh):
        kv = RingPagedKVCache(cfg, slots, max_len, device="cpu", mesh=mesh)
        for toks in steps_tokens:
            logits, _ = TT.decode_step(params, cfg, kv.tree,
                                       kv.rows(_t(toks)))
            out["decode"].append(_np(kv.whole(logits)))
        kv = RingPagedKVCache(cfg, slots, max_len, device="cpu", mesh=mesh)
        for toks, nv in chunks:
            logits, _ = TT.prefill_chunk(params, cfg, kv.tree,
                                         kv.rows(_t(toks)), kv.rows(_t(nv)))
            out["chunk"].append(_np(kv.whole(logits)))
        out["lengths"] = kv.lengths
        out["cache"] = {k: [_np(a) for a in v] if isinstance(v, list)
                        else _np(v) for k, v in kv.tree.items()}
    return out


def case_state_serve(mesh_shape, arch, overrides, weights, chunks, steps,
                     slots, max_len, prompt):
    """Ragged ``prefill_chunk`` calls then ``decode_step`` with frozen slots
    over the rank's block of the family's state cache (the rank's rows in,
    every slot's logits gathered back, as the engine calls it): the logits
    and the rank's cache block after every call; then the whole-prompt
    ``prefill`` of ``prompt`` (every slot) into a fresh cache."""
    from repro_torch.serve.cache import make_cache

    mesh = make_local_mesh(*mesh_shape, device="cpu")
    cfg = _smoke(arch, overrides)
    params = shard_params(params_from_jax(weights, cfg, device="cpu"), cfg,
                          mesh)
    model = get_model(cfg)
    out = {"logits": [], "cache": []}
    with mesh_utils.use_mesh(mesh), torch.no_grad():
        kv = make_cache(cfg, model, slots, max_len, device="cpu", mesh=mesh)
        out["type"] = type(kv).__name__
        out["shapes"] = {k: tuple(v.shape) for k, v in kv.tree.items()}
        for toks, nv in chunks:
            logits, _ = model.prefill_chunk(params, cfg, kv.tree,
                                            kv.rows(_t(toks)), kv.rows(_t(nv)))
            out["logits"].append(_np(kv.whole(logits)))
            out["cache"].append({k: _np(v).copy() for k, v in kv.tree.items()})
        for toks, act in steps:
            logits, _ = model.decode_step(params, cfg, kv.tree,
                                          kv.rows(_t(toks)),
                                          active=kv.rows(_t(act)))
            out["logits"].append(_np(kv.whole(logits)))
            out["cache"].append({k: _np(v).copy() for k, v in kv.tree.items()})
        out["lengths"] = kv.lengths
        kv = make_cache(cfg, model, slots, max_len, device="cpu", mesh=mesh)
        logits, _ = model.prefill(params, cfg, {"tokens": kv.rows(_t(prompt))},
                                  kv.tree)
        out["prefill"] = (_np(kv.whole(logits)),
                          {k: _np(v) for k, v in kv.tree.items()})
    return out


def case_engine(mesh_shape, arch, overrides, weights, mix, slots, max_len,
                chunk, spec_k):
    """Streams and counters of the mesh engine; a ``mix`` entry is (prompt,
    max_new_tokens) or (prompt, max_new_tokens, SamplingParams kwargs)."""
    from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams

    mesh = make_local_mesh(*mesh_shape, device="cpu")
    cfg = _smoke(arch, overrides)
    params = params_from_jax(weights, cfg, device="cpu")
    eng = Engine(cfg, params, EngineConfig(slots=slots, max_len=max_len,
                                           chunk=chunk, spec_k=spec_k,
                                           mesh=mesh), device="cpu")
    done = eng.run([Request(prompt=m[0], max_new_tokens=m[1],
                            sampling=SamplingParams(**m[2]) if len(m) > 2
                            else None) for m in mix])
    keys = ("spec_rounds", "spec_drafted_tokens", "spec_accepted_tokens",
            "spec_emitted_tokens", "draft_dispatches", "verify_dispatches",
            "decode_dispatches", "prefill_dispatches", "generated_tokens")
    return {"streams": {len(r.prompt): np.asarray(r.out) for r in done},
            "stats": {k: eng.stats[k] for k in keys}}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def end_early(rank: int, how: str):
    """Rank 1 ends without a result: ``how`` "exit" leaves the process with
    code 3 (a crash or a kill), "raise" raises; the other ranks wait, as
    a peer blocked in a collective would."""
    import os
    import time

    if rank == 1:
        if how == "exit":
            os._exit(3)
        raise ValueError("rank 1 failed")
    time.sleep(120)
    return rank


def run_cases(rank: int, cases: list) -> dict:
    """Every case of ``cases`` ((name, kwargs) pairs) in order, on every
    rank; {name: result}."""
    torch.manual_seed(0)
    return {name: CASES[name.split(":")[0]](**kw) for name, kw in cases}
