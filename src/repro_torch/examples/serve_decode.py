"""Batched serving with MRA decode: top-m KV-page selection per new token.

Port of the reference's ``examples/serve_decode.py``: a randomly
initialized smoke-size model serves four requests through the
continuous-batching engine (chunked prefill, ragged slots, per-request
sampling), once with MRA-2 serving attention and once with exact
attention on the same prompts, and the streams are compared. On the card
the MRA engine runs the CUDA serving kernel. The recurrent families serve
through their state caches (one pass: no attention to compare).
``--mesh DxM`` serves on a (data, model) mesh of D·M ranks spawned here
(``launch.mesh.spawn``: NCCL with a card a rank, gloo on the CPU or ranks
sharing one card): every rank builds the mesh ``Engine`` (slots over
"data", KV heads over "model") and runs the same requests; rank 0 prints.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu \\
        --temperature 0.8 --seed 7
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu \\
        --mesh 2x2
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_smoke_config
from repro_torch.examples.train_lm import parse_dims
from repro_torch.models.params import init_params
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams

RECURRENT_ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
ARCHS = ("qwen3-1.7b", "qwen2-7b", "llama3.2-3b", "yi-6b", "kimi-k2-1t-a32b",
         "granite-moe-3b-a800m", *RECURRENT_ARCHS)


def _requests(cfg, args):
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(1, cfg.vocab, size=n),
                    max_new_tokens=args.new_tokens,
                    sampling=SamplingParams(
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed + i))
            for i, n in enumerate((5, 9, 13, 7))]


def _engine(cfg, args, spec_k=0, mesh=None):
    """The engine on one device, or on ``mesh`` (whole parameters, cut to
    the rank's blocks by the engine)."""
    device = mesh.device if mesh is not None else args.device
    params = init_params(cfg, seed=0, device=device)
    if args.ckpt_dir:
        step = latest_step(args.ckpt_dir)
        if step is not None:
            params = restore(args.ckpt_dir, step, params)
            _say(args, f"restored checkpoint step {step}")
    return Engine(cfg, params, EngineConfig(slots=4, max_len=128,
                                            chunk=args.chunk, spec_k=spec_k,
                                            mesh=mesh),
                  device=device)


def _say(args, *line, **kw):
    """print on one device, or on rank 0 of a mesh"""
    if getattr(args, "rank", 0) == 0:
        print(*line, **kw)


def _telemetry(eng, args):
    if getattr(args, "rank", 0) != 0:
        return
    if args.metrics:
        print(eng.telemetry.prometheus_text(), end="")
    if args.trace:
        n = eng.telemetry.trace.export_jsonl(args.trace)
        print(f"wrote {n} Chrome-trace events to {args.trace}")


def _rank(rank, args, dims):
    from repro_torch.launch.mesh import make_local_mesh

    args.rank = rank
    return _serve(args, make_local_mesh(*dims, device=args.device))


def run(args) -> dict:
    """{kind: {prompt length: tokens}} and, for the MRA kinds, the number
    of identical streams against exact attention (rank 0's under a mesh:
    every rank returns the same streams)."""
    if args.arch in RECURRENT_ARCHS and args.spec_k:
        raise SystemExit("--spec-k needs the MRA paged-KV cache")
    dims = parse_dims(args.mesh)
    if dims[0] * dims[1] == 1:
        return _serve(args)
    from repro_torch.launch.mesh import spawn

    return spawn(_rank, dims[0] * dims[1], args, dims, device=args.device,
                 timeout=3600)[0]


def _serve(args, mesh=None) -> dict:
    if mesh is not None:
        _say(args, f"serving on a {mesh.shape['data']} x "
                   f"{mesh.shape['model']} (data x model) mesh")
    if args.arch in RECURRENT_ARCHS:
        cfg = get_smoke_config(args.arch)
        eng = _engine(cfg, args, mesh=mesh)
        done = eng.run(_requests(cfg, args))
        _say(args, f"[{args.arch}] generated "
                   f"({eng.stats['prefill_dispatches']} prefill + "
                   f"{eng.stats['decode_dispatches']} decode dispatches):")
        for r in done:
            _say(args, f"  req ({len(r.prompt)} prompt toks) -> "
                       f"{r.out.tolist()}")
        _telemetry(eng, args)
        return {"streams": {args.arch: {len(r.prompt): r.out.tolist()
                                        for r in done}}}
    outs = {}
    for kind in ("mra2", "full"):
        cfg = get_smoke_config(args.arch)
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, kind=kind, decode_blocks=2))
        spec_k = args.spec_k if kind == "mra2" else 0
        eng = _engine(cfg, args, spec_k, mesh)
        done = eng.run(_requests(cfg, args))
        outs[kind] = {len(r.prompt): r.out.tolist() for r in done}
        st = eng.stats
        note = ""
        if spec_k:
            rate = st["spec_accepted_tokens"] / max(st["spec_drafted_tokens"],
                                                    1)
            note = (f" + {st['draft_dispatches']} draft + "
                    f"{st['verify_dispatches']} verify; accept rate "
                    f"{rate:.2f}")
        _say(args, f"[{kind}] generated ({st['prefill_dispatches']} "
                   f"prefill + {st['decode_dispatches']} decode "
                   f"dispatches{note}):")
        for r in done:
            _say(args, f"  req ({len(r.prompt)} prompt toks) -> "
                       f"{r.out.tolist()}")
        if kind == "mra2":
            _telemetry(eng, args)
    keys = sorted(outs["full"])
    agree = sum(int(outs["mra2"][k] == outs["full"][k]) for k in keys)
    mode = "greedy argmax" if args.temperature <= 0 else "seeded sampling"
    _say(args, f"\nMRA decode vs exact decode: {agree}/{len(keys)} "
               f"sequences identical ({mode} robustness to approximation)")
    return {"streams": outs, "identical": agree}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCHS)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk size (tokens per slot per dispatch)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples (top-k / top-p below)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="request sampling seed (request i uses seed + i)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft length (0 = plain decode; MRA "
                         "only: the pyramid is the draft model)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export the MRA engine's Chrome-trace JSONL")
    ap.add_argument("--metrics", action="store_true",
                    help="print the MRA engine's Prometheus-format telemetry")
    ap.add_argument("--mesh", default="1",
                    help="'D' or 'DxM' (data x model) ranks; 1 = one device")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
