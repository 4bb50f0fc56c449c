"""Train a small causal LM with MRA-2 attention against exact attention.

Port of the reference's ``examples/train_lm.py``: the same presets (a
~15M-parameter ``small`` model, a ~110M ``full`` one), trained by the
port's ``train()`` on the synthetic corpus, once per attention kind, and
the final losses compared (the paper's Tab. 2: MRA-2 trains on par with
softmax attention). On the card MRA-2 runs the block-sparse kernels.
``--mesh DxM`` trains on a (data, model) mesh of D·M ranks spawned here
(``launch.mesh.spawn``: NCCL with a card a rank, gloo on the CPU or ranks
sharing one card).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --steps 3 --attention mra2 --mesh 2x2
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.core.attention import AttentionSpec
from repro_torch.train import TrainConfig, train

PRESETS = {
    # ~15M params: the end-to-end demo
    "small": dict(num_layers=4, d_model=256, num_heads=8, kv_heads=4,
                  d_ff=1024, vocab=8192, head_dim=32, seq=256, batch=8),
    # ~110M params: a few hundred steps on a card
    "full": dict(num_layers=12, d_model=768, num_heads=12, kv_heads=12,
                 d_ff=3072, vocab=32768, head_dim=64, seq=1024, batch=32),
}


def build_cfg(p, kind: str) -> ModelConfig:
    return ModelConfig(
        name=f"train-lm-{kind}", family="dense",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], kv_heads=p["kv_heads"], d_ff=p["d_ff"],
        vocab=p["vocab"], head_dim=p["head_dim"],
        attention=AttentionSpec(kind=kind, block_size=32, blocks_per_row=4))


def _train(kind, preset, steps, ckpt_dir, device, mesh=None):
    p = PRESETS[preset]
    tc = TrainConfig(steps=steps, lr=1e-3, warmup=20, log_every=20,
                     ckpt_dir=ckpt_dir and f"{ckpt_dir}/{kind}")
    hist = []
    train(build_cfg(p, kind), ShapeCfg(p["seq"], p["batch"]), tc,
          device=device, mesh=mesh,
          on_metrics=lambda s, m: hist.append(m["loss"]))
    return hist


def _rank(rank, kind, preset, steps, ckpt_dir, device, dims):
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(*dims, device=device)
    return _train(kind, preset, steps, ckpt_dir, mesh.device, mesh)


def parse_dims(spec: str):
    """'D' or 'DxM' -> (data, model)."""
    parts = [int(x) for x in spec.lower().split("x")]
    return (parts[0], 1) if len(parts) == 1 else tuple(parts)


def run(preset="small", steps=200, attention="mra2,full", mesh="1",
        ckpt_dir=None, device=None) -> dict:
    """{kind: per-step losses} (rank 0's under a mesh)."""
    dims = parse_dims(mesh)
    curves = {}
    for kind in attention.split(","):
        print(f"=== training with attention={kind} ===")
        if dims[0] * dims[1] == 1:
            curves[kind] = _train(kind, preset, steps, ckpt_dir, device)
        else:
            from repro_torch.launch.mesh import spawn

            curves[kind] = spawn(_rank, dims[0] * dims[1], kind, preset,
                                 steps, ckpt_dir, device, dims,
                                 device=device, timeout=3600)[0]
    print("\nfinal losses:")
    for kind, hist in curves.items():
        k = max(len(hist) // 10, 1)
        print(f"  {kind:8s} start={sum(hist[:k]) / k:.4f} "
              f"final={sum(hist[-k:]) / k:.4f}")
    if "mra2" in curves and "full" in curves:
        k = max(len(curves["mra2"]) // 10, 1)
        gap = sum(curves["mra2"][-k:]) / k - sum(curves["full"][-k:]) / k
        print(f"  MRA-2 vs full final-loss gap: {gap:+.4f} "
              "(paper Tab. 2: MRA-2 trains on par with softmax attention)")
    return curves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--attention", default="mra2,full",
                    help="comma-separated attention kinds to train")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="1",
                    help="'D' or 'DxM' (data x model) ranks; 1 = one device")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.preset, args.steps, args.attention, args.mesh,
               args.ckpt_dir, args.device)


if __name__ == "__main__":
    main()
