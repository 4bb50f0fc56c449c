"""A serving cell: ``Engine.run`` over jobs of long documents.

Set-up draws the weights, builds the engine and serves one warm-up job
(every slot prefills a whole chunk, then decodes), so that the kernels are
built and every dispatch shape has run. The window then serves jobs back
to back until ``seconds`` have passed and closes when the last job started
inside it ends. After it, a sample of the finished requests is held to
the plain reference (``check.serve``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import traffic as gen
from . import weights, work
from .clock import now


def run(ctx) -> None:
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    t, model, dev = ctx.traffic, ctx.model, ctx.device
    params, _ = weights.make(model, ctx.seed, dev)
    e = t["engine"]
    engine = Engine(ctx.cfg, params, EngineConfig(
        slots=e["slots"], max_len=e["max_len"], chunk=e["chunk"]),
        device=dev)
    vocab = model["vocab"]
    engine.run([Request(p, max_new_tokens=n)
                for p, n in gen.warmup_job(t, vocab, ctx.seed)])
    ctx.sync()
    engine.reset_stats()

    done, jobs = [], 0
    ctx.window_start()
    with ctx.traced():
        t0 = now()
        while now() - t0 < ctx.seconds:
            reqs = [Request(p, max_new_tokens=n)
                    for p, n in gen.job(t, vocab, ctx.seed, jobs)]
            out = engine.run(reqs)
            jobs += 1
            done.append((reqs, out))
        ctx.sync()
        window_s = now() - t0
    ctx.window_end()

    reqs = [r for job, _ in done for r in job]
    finished = {id(r) for _, out in done for r in out}
    ok = [r for r in reqs if id(r) in finished and r.out is not None
          and len(r.out) == r.max_new_tokens]
    tokens = sum(len(r.prompt) + r.max_new_tokens for r in reqs)
    gaps = [b - a for r in ok for a, b in zip(r.trace.token_times,
                                             r.trace.token_times[1:])]
    ctx.attempted, ctx.failed = len(reqs), len(reqs) - len(ok)
    ctx.window_s = window_s
    ctx.notes.update(jobs=jobs, requests=len(reqs), tokens=tokens,
                     token_gaps=len(gaps))
    ctx.e2e["serve_tok_s"] = tokens / window_s
    if gaps:
        ctx.e2e["itl_p95_ms"] = 1e3 * float(np.percentile(gaps, 95))
    m = engine.telemetry.metrics
    ctx.layer_inputs.update(
        prefill_s=m.get("prefill_chunk_seconds").total,
        prefill_n=engine.stats["prefill_dispatches"],
        decode_s=m.get("decode_step_seconds").total,
        decode_n=engine.stats["decode_dispatches"],
        model_flops=sum(work.serve_request_flops(model, len(r.prompt),
                                                 r.max_new_tokens)
                        for r in reqs))
    ctx.read_memory_peak()
    del engine, params
    ctx.free()
    ctx.served = [(np.asarray(r.prompt), np.asarray(r.out)) for r in ok]
    from .check import serve as check_serve

    check_serve(ctx)
