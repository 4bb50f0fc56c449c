"""Op profile of a dry-run step: where its operations go and what is live.

The counterpart of ``repro/launch/hlo_profile.py``, which reads the
compiled HLO's dot ops by their metadata op names. Here one cell's step
(``launch/dryrun.py``) runs on the meta device under a dispatch mode that
prices every matmul-like op with ``torch.utils.flop_counter``'s formulas
and every kernel call with ``kernels/cost.py``'s, each charged to the
innermost function of ``repro_torch`` on the Python stack that issued it
(``module.function``; the backward's ops to their autograd node); the
largest storages alive at the step's peak come from the dry run's live-
bytes count.

  PYTHONPATH=src python -m repro_torch.launch.op_profile --arch qwen3-1.7b \\
      --shape train_4k --mesh 1x1 --batch 2 --layers 2
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh

__all__ = ["OpProfile", "profile", "report"]

_PKG = str(Path(__file__).resolve().parents[1])
_SELF = (str(Path(__file__).resolve()), str(Path(dryrun.__file__).resolve()))


def _issuer() -> str:
    """``module.function`` of the innermost repro_torch frame outside the
    profiler; an op the backward engine runs under ``train.loop`` is
    charged to its autograd node (``<backward> MmBackward0``)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and path not in _SELF:
            mod = Path(path).relative_to(_PKG).with_suffix("")
            name = f"{'.'.join(mod.parts)}.{f.f_code.co_name}"
            node = torch._C._current_autograd_node()
            if node is not None and name.startswith("train.loop"):
                return f"<backward> {node.name()}"
            return name
        f = f.f_back
    return "<other>"


class OpProfile(TorchDispatchMode):
    """Matmul FLOPs by issuing function (``by_fn``) and by aten op."""

    def __init__(self):
        super().__init__()
        self.by_fn = collections.Counter()
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:  # FlopCounterMode's own call
            flops = fn(*args, **kwargs, out_val=out)
            self.by_fn[_issuer()] += flops
            self.by_op[func.overloadpacket.__name__] += flops
        return out


def profile(arch: str, shape: str, mesh, *, top: int = 15, batch=None,
            layers=None, **kw) -> dict:
    """The op profile of one step of the cell (``dryrun.lower_cell``'s
    arguments; a train cell at the depth given, not extrapolated): matmul
    FLOPs by issuing function and by op, the kernels' operations, and the
    largest storages alive at the peak."""
    import dataclasses

    shp = dryrun.SHAPES[shape]
    if batch is not None:
        shp = dataclasses.replace(shp, global_batch=batch)
    cfg, rules = dryrun._config(arch, shp, kw.pop("opt", False),
                                kw.pop("attention_override", None),
                                kw.pop("config_override", None), layers)
    prof = OpProfile()
    chips = 1
    for v in mesh.shape.values():
        chips *= v
    with prof:
        run = dryrun._run(cfg, shp, None if chips == 1 else mesh, rules)
    kernels = {k: v["flops"] for k, v in run["kernels"].items()}
    total = sum(prof.by_fn.values()) + sum(kernels.values())
    by_fn = prof.by_fn + collections.Counter(
        {f"kernel {k}": v for k, v in kernels.items()})
    tag = "x".join(str(v) for v in mesh.shape.values())
    return {"cell": f"{arch} x {shape} x {tag} ({cfg.num_layers} layers)",
            "total_flops": total,
            "by_function": by_fn.most_common(top),
            "by_op": prof.by_op.most_common(top),
            "largest_live": run["largest_live"],
            "peak_bytes": run["peak"]}


def report(p: dict) -> None:
    total = max(p["total_flops"], 1)
    print(f"{p['cell']}: {p['total_flops']:.3e} FLOPs a rank")
    for name, fl in p["by_function"]:
        print(f"  {fl:.3e}  ({fl / total:5.1%})  {name}")
    print(f"largest storages alive at the peak "
          f"({p['peak_bytes'] / 2**30:.2f} GiB):")
    for t in p["largest_live"]:
        print(f"  {t['bytes'] / 2**20:10.1f} MiB  {t['op']:<14} "
              f"{t['dtype']} {t['shape']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="16x16",
                    help="DxM or PxDxM abstract mesh (rank 0's view)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    dims = [int(x) for x in args.mesh.lower().split("x")]
    mesh = (AbstractMesh(dims[1], dims[2], pod=dims[0]) if len(dims) == 3
            else AbstractMesh(*dims))
    report(profile(args.arch, args.shape, mesh, top=args.top,
                   batch=args.batch, layers=args.layers))


if __name__ == "__main__":
    main()

