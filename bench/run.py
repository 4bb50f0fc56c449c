#!/usr/bin/env python3
"""One run of one benchmark cell of ``repro_torch``:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, metrics and bounds are in
``BENCHMARK.json``; the harness is ``bench/mrabench``.
"""
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]
# the program's caches stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ.setdefault("USE_FLAX", "0")

from mrabench.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
