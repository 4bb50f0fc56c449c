"""Roofline over the dry run's cells, for H100s (``launch/dryrun.py``).

Port of ``repro/launch/roofline.py``, with the H100's rates
(``kernels/cost.py``) in place of the reference's TPU constants. Per cell,
a rank's terms:

    compute term    = (matmul FLOPs + the kernels' operations) / bf16 peak
    memory term     = (argument bytes + the kernels' bytes) / HBM rate
    collective term = Σ_axis collective bytes on the axis / the axis' link

The mesh is laid out model-innermost at 8 GPUs a node, so an axis whose
stride times size stays within 8 ranks (the model axis up to 8 wide) goes
over NVLink (450 GB/s a direction), any other over InfiniBand (50 GB/s a
GPU). Beside them: the reference's MODEL_FLOPS (6·N·D / 2·N·D) per rank,
the useful ratio MODEL_FLOPS / counted FLOPs, the roofline fractions
(useful compute time over the sum of the terms, over their max, and over
the max with the memory term's floor, the arguments alone), the peak GiB
a rank and ``fits_80g``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline            # table
    PYTHONPATH=src python -m repro_torch.launch.roofline --markdown
    PYTHONPATH=src python -m repro_torch.launch.roofline --json-out rows.json
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.kernels.cost import (
    BF16_FLOP_PER_S,
    GPUS_PER_NODE,
    HBM_BYTES,
    HBM_BYTES_PER_S,
    IB_BYTES_PER_S,
    NVLINK_BYTES_PER_S,
)
from repro_torch.launch.dryrun import RESULTS_DIR

PEAK_FLOPS = BF16_FLOP_PER_S
HBM_BW = HBM_BYTES_PER_S


def load_cells(results_dir=RESULTS_DIR):
    return [json.load(open(f)) for f in
            sorted(glob.glob(os.path.join(str(results_dir), "*.json")))]


def axis_links(axes: dict) -> dict:
    """Bytes/s of each mesh axis: the axes laid out innermost last (model
    innermost); an axis inside a node of GPUS_PER_NODE ranks rides NVLink,
    else InfiniBand."""
    out, stride = {}, 1
    for name in reversed(list(axes)):
        span = stride * axes[name]
        out[name] = NVLINK_BYTES_PER_S if span <= GPUS_PER_NODE else IB_BYTES_PER_S
        stride = span
    return out


def analyze(cell: dict) -> dict | None:
    if cell.get("status") != "ok":
        return None
    cost = cell["cost"]
    mem = cell["memory"]
    flops = cost["flops_per_device"]
    bts = mem["arguments"] + cost["kernel_bytes_per_device"]
    links = axis_links(cell.get("mesh_axes", {}))
    t_l = 0.0
    for key, n in cell.get("collectives_by_axis", {}).items():
        axis = key.split(":", 1)[1]
        t_l += n / links.get(axis, IB_BYTES_PER_S)
    t_c = flops / PEAK_FLOPS
    t_m = bts / HBM_BW
    t_m_floor = mem["arguments"] / HBM_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_l, "collective"))[1]
    dom_floor = max((t_c, "compute"), (t_m_floor, "memory"),
                    (t_l, "collective"))[1]
    useful = cell.get("model_flops_total", 0.0) / cell.get("chips", 1)
    peak = mem["peak_bytes"]
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "compute_s": t_c, "memory_s": t_m, "memory_floor_s": t_m_floor,
        "collective_s": t_l, "dominant": dom, "dominant_floor": dom_floor,
        "model_flops_per_device": useful, "counted_flops_per_device": flops,
        "useful_ratio": (useful / flops) if flops else 0.0,
        "mem_gib_per_device": peak / 2**30,
        "fits_80g": peak < HBM_BYTES,
        "roofline_fraction": (useful / PEAK_FLOPS) / max(t_c + t_m + t_l, 1e-30),
        "roofline_fraction_overlap": (useful / PEAK_FLOPS)
        / max(t_c, t_m, t_l, 1e-30),
        "roofline_fraction_floor": (useful / PEAK_FLOPS)
        / max(t_c, t_m_floor, t_l, 1e-30),
        "kernels_unbuilt": cell.get("kernels_unbuilt", []),
    }


def table(cells, markdown=False):
    rows = [r for r in (analyze(c) for c in cells) if r]
    skips = [c for c in cells if c.get("status") == "skipped"]
    errs = [c for c in cells if c.get("status") == "error"]
    hdr = ["arch", "shape", "mesh", "compute_s", "memory_s", "mem_floor_s",
           "collective_s", "dom", "dom_floor", "useful_ratio", "mem_GiB",
           "fits_80g", "rf_sum", "rf_overlap", "rf_floor"]
    lines = []
    sep = " | " if markdown else "  "
    if markdown:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        vals = [r["arch"], r["shape"], r["mesh"],
                f"{r['compute_s']:.3e}", f"{r['memory_s']:.3e}",
                f"{r['memory_floor_s']:.3e}", f"{r['collective_s']:.3e}",
                r["dominant"], r["dominant_floor"],
                f"{r['useful_ratio']:.2f}", f"{r['mem_gib_per_device']:.1f}",
                "yes" if r["fits_80g"] else "no",
                f"{r['roofline_fraction']:.3f}",
                f"{r['roofline_fraction_overlap']:.3f}",
                f"{r['roofline_fraction_floor']:.3f}"]
        lines.append(("| " if markdown else "") + sep.join(vals)
                     + (" |" if markdown else ""))
    for c in skips:
        lines.append(f"{'| ' if markdown else ''}{c['arch']}{sep}{c['shape']}"
                     f"{sep}{c['mesh']}{sep}SKIPPED: {c['reason']}"
                     f"{' |' if markdown else ''}")
    for c in errs:
        lines.append(f"{'| ' if markdown else ''}{c['arch']}{sep}{c['shape']}"
                     f"{sep}{c['mesh']}{sep}ERROR: {c['error'][:90]}"
                     f"{' |' if markdown else ''}")
    return "\n".join(lines), rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--results-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    cells = load_cells(args.results_dir)
    txt, rows = table(cells, markdown=args.markdown)
    print(txt)
    if rows:
        print("\nPer-dominant-term counts:",
              {d: sum(1 for r in rows if r["dominant"] == d)
               for d in ("compute", "memory", "collective")})
        worst = sorted(rows, key=lambda r: r["roofline_fraction"])[:3]
        print("Worst roofline fractions:",
              [(r["arch"], r["shape"], r["mesh"],
                round(r["roofline_fraction"], 4)) for r in worst])
        collb = sorted(rows, key=lambda r: -r["collective_s"])[:3]
        print("Most collective-bound:",
              [(r["arch"], r["shape"], r["mesh"], f"{r['collective_s']:.2e}s")
               for r in collb])
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
