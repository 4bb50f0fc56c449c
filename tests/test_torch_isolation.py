"""The port stands alone: repro_torch and chip_smoke.py never touch JAX.

An AST scan of every module of ``src/repro_torch`` and of ``chip_smoke.py``
finds no import of ``jax`` or of the reference package ``repro``; and a
fresh interpreter with both blocked in ``sys.modules`` imports the port and
serves a request on the CPU.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in _sources()}
    assert {"chunk_attn.py", "engine.py", "transformer.py", "mra_decode.py",
            "chip_smoke.py"} <= names


_SERVE_WITHOUT_JAX = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import init_params
from repro_torch.serve import Engine, EngineConfig, Request
cfg = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"),
             EngineConfig(slots=2, max_len=32, chunk=8), device="cpu")
out = eng.run([Request(prompt=np.arange(1, 12), max_new_tokens=5)])[0].out
assert len(out) == 5 and 0 <= int(out.min()) and int(out.max()) < cfg.vocab
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
               if sys.modules[m] is not None)
print("served", out.tolist())
"""


def test_port_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "served" in res.stdout


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: chip_smoke.py exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
