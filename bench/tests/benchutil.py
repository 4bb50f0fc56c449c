"""What the benchmark's CPU tests share: the harness and the program on
the path, and small copies of the cells."""
import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_spec(cell: str, **model) -> dict:
    """The cell's spec at a size a test run holds: 2 layers, d 64, vocab
    512, block 16, a short job or batch; ``model`` overrides the model."""
    from mrabench import cli

    spec = copy.deepcopy(cli.load_cell(cell))
    m = spec["config"]["model"]
    m.update(num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
             vocab=512)
    if m.get("moe"):
        m["moe"].update(num_experts=5, top_k=2, d_ff_expert=32)
    else:
        m["d_ff"] = 128
    m["attention"].update(block_size=16, blocks_per_row=2, decode_blocks=2)
    m.update(model)
    t = spec["traffic"]
    if t["kind"] == "serve":
        t["engine"] = {"slots": 4, "max_len": 256, "chunk": 32}
        t.update(job_requests=6,
                 prompt={"median": 64, "sigma": 0.7, "min": 20, "max": 200},
                 output={"min": 4, "max": 8}, check={"served_tokens": 24})
    else:
        t.update(seq_len=32, batch=2)
    return spec
