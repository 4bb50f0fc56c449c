"""The port stands alone: repro_torch and chip_smoke.py never touch JAX.

An AST scan of every module of ``src/repro_torch`` and of ``chip_smoke.py``
finds no import of ``jax`` or of the reference package ``repro``; and a
fresh interpreter with both blocked in ``sys.modules`` imports the port,
serves a request (also past the window, through the H = 3 hierarchy) and
trains (with a checkpoint) on the CPU; the hubert encoder and the internvl
VLM train, and internvl prefills patches + text and decodes, the same way;
and two spawned ranks, each blocking both, train and serve on a (1, 2)
mesh (``distributed/``, ``launch/mesh.py``).
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
            "hier.py", "block_sparse_attn.py", "mra.py", "adamw.py",
            "pipeline.py", "ckpt.py", "loop.py", "chip_smoke.py", "moe.py",
            "registry.py", "granite_moe_3b_a800m.py", "kimi_k2_1t_a32b.py",
            "qwen2_7b.py", "yi_6b.py", "compression.py",
            "hubert_xlarge.py", "internvl2_1b.py", "sharding.py",
            "mesh_utils.py", "collectives.py",
            "mesh.py"} <= names


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


_SERVE_H3_WITHOUT_JAX = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import numpy as np
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import init_params
from repro_torch.serve import Engine, EngineConfig, Request
cfg = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
cfg = cfg.replace(attention=cfg.attention.replace(levels=3))
eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"),
             EngineConfig(slots=1, max_len=32, chunk=32), device="cpu")
out = eng.run([Request(prompt=np.arange(1, 120), max_new_tokens=4)])[0].out
occ = eng.kv.occupancy()
assert len(out) == 4 and eng.chunk == 16 and occ["tail_tokens"] > 0
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
               if sys.modules[m] is not None)
print("served past the window", out.tolist(), occ)
"""


def test_port_serves_past_the_window_with_jax_blocked():
    """The H = 3 hierarchy (core/hier.py) needs nothing of the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _SERVE_H3_WITHOUT_JAX],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "served past the window" in res.stdout


_TRAIN_WITHOUT_JAX = r"""
import dataclasses, math, sys, tempfile
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.train import TrainConfig, train
cfg = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=2)
losses = []
with tempfile.TemporaryDirectory() as d:
    train(cfg, shape, TrainConfig(steps=2, ckpt_dir=d, ckpt_every=1),
          device="cpu", on_metrics=lambda s, m: losses.append(m["loss"]))
assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
               if sys.modules[m] is not None)
print("trained", losses)
"""


def test_port_trains_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _TRAIN_WITHOUT_JAX], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "trained" in res.stdout


_TRAIN_MOE_WITHOUT_JAX = r"""
import dataclasses, math, sys, tempfile
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.train import TrainConfig, train
cfg = get_smoke_config("granite-moe-3b-a800m", activ_dtype="float32",
                       remat="dots")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=2)
seen = []
with tempfile.TemporaryDirectory() as d:
    train(cfg, shape, TrainConfig(steps=2, microbatches=2,
                                  grad_compression="bf16_ef", ckpt_dir=d,
                                  ckpt_every=1), device="cpu",
          on_metrics=lambda s, m: seen.append((m["loss"], m["aux_loss"])))
assert len(seen) == 2 and all(math.isfinite(x) and a > 0 for x, a in seen)
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
               if sys.modules[m] is not None)
print("trained moe", seen)
"""


def test_port_trains_moe_with_jax_blocked():
    """The MoE family, remat="dots", bf16 error feedback over two
    microbatches and the checkpointer need nothing of the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _TRAIN_MOE_WITHOUT_JAX],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "trained moe" in res.stdout


_FAMILIES_WITHOUT_JAX = r"""
import dataclasses, math, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import torch
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.data import make_batch
from repro_torch.models import transformer
from repro_torch.models.params import init_params
from repro_torch.serve.cache import RingPagedKVCache
from repro_torch.train import TrainConfig, train
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=2)
for arch in ("hubert-xlarge", "internvl2-1b"):
    cfg = get_smoke_config(arch, activ_dtype="float32")
    seen = []
    train(cfg, shape, TrainConfig(steps=1), device="cpu",
          on_metrics=lambda s, m: seen.append(m["loss"]))
    assert len(seen) == 1 and math.isfinite(seen[0]), arch
cfg = get_smoke_config("internvl2-1b", activ_dtype="float32")
batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape).items()}
cache = RingPagedKVCache(cfg, 2, 80, device="cpu").tree
params = init_params(cfg, seed=0, device="cpu")
logits, cache = transformer.prefill(params, cfg, batch, cache)
logits, cache = transformer.decode_step(params, cfg, cache,
                                        logits.argmax(-1))
assert cache["lengths"].tolist() == [65, 65]
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
               if sys.modules[m] is not None)
print("families ok")
"""


def test_port_families_run_with_jax_blocked():
    """hubert trains, internvl trains and serves its patches, with nothing
    of the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _FAMILIES_WITHOUT_JAX],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "families ok" in res.stdout


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


_RWKV_BASELINES_WITHOUT_JAX = r"""
import dataclasses, math, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import numpy as np
import torch
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.core import baselines
from repro_torch.core.attention import AttentionSpec, self_attention
from repro_torch.models.params import init_params
from repro_torch.serve import Engine, EngineConfig, Request
from repro_torch.train import TrainConfig, train
cfg = get_smoke_config("rwkv6-7b", activ_dtype="float32")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=2)
seen = []
train(cfg.replace(remat="full"), shape, TrainConfig(steps=1), device="cpu",
      on_metrics=lambda s, m: seen.append(m["loss"]))
assert len(seen) == 1 and math.isfinite(seen[0])
params = init_params(cfg, seed=0, device="cpu")
reqs = [Request(prompt=np.arange(1, 30), max_new_tokens=20)]
Engine(cfg, params, EngineConfig(slots=1, max_len=16, chunk=8),
       device="cpu").run(reqs)
assert len(reqs[0].out) == 20
q, k, v = torch.randn(3, 1, 2, 64, 16).unbind(0)
for kind in baselines.REGISTRY:
    out = self_attention(q, k, v, AttentionSpec(kind=kind, block_size=16))
    assert out.shape == q.shape and bool(torch.isfinite(out).all()), kind
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
               if sys.modules[m] is not None)
print("rwkv6 and baselines ok")
"""


def test_rwkv6_and_baselines_run_with_jax_blocked():
    """rwkv6 trains and serves past max_len, and every baseline kind runs
    through ``self_attention``, with nothing of the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _RWKV_BASELINES_WITHOUT_JAX],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "rwkv6 and baselines ok" in res.stdout


_RGEMMA_WITHOUT_JAX = r"""
import dataclasses, math, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import numpy as np
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.core.attention import AttentionSpec
from repro_torch.models.params import init_params
from repro_torch.serve import Engine, EngineConfig, Request
from repro_torch.train import TrainConfig, train
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=2)
for attn in (None, AttentionSpec(kind="mra2", block_size=16,
                                 blocks_per_row=2)):
    cfg = get_smoke_config("recurrentgemma-9b", activ_dtype="float32")
    cfg = cfg if attn is None else cfg.replace(attention=attn)
    seen = []
    train(cfg.replace(remat="full"), shape, TrainConfig(steps=1),
          device="cpu", on_metrics=lambda s, m: seen.append(m["loss"]))
    assert len(seen) == 1 and math.isfinite(seen[0])
    params = init_params(cfg, seed=0, device="cpu")
    reqs = [Request(prompt=np.arange(1, 50), max_new_tokens=20)]
    Engine(cfg, params, EngineConfig(slots=1, max_len=24, chunk=16),
           device="cpu").run(reqs)
    assert len(reqs[0].out) == 20
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
               if sys.modules[m] is not None)
print("recurrentgemma ok")
"""


def test_recurrentgemma_runs_with_jax_blocked():
    """recurrentgemma (the ``local`` preset and the MRA-2 variant) trains
    and serves past its window and max_len with nothing of the
    reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _RGEMMA_WITHOUT_JAX],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "recurrentgemma ok" in res.stdout


_MESH_RANK = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import dataclasses, math
import numpy as np


def rank(r):
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.train import TrainConfig, train

    mesh = make_local_mesh(1, 2, device="cpu")
    cfg = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=2)
    seen = []
    train(cfg, shape, TrainConfig(steps=1, log_every=100), device="cpu",
          mesh=mesh, on_metrics=lambda s, m: seen.append(m["loss"]))
    eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"),
                 EngineConfig(slots=2, max_len=32, chunk=8, mesh=mesh),
                 device="cpu")
    out = eng.run([Request(prompt=np.arange(1, 12), max_new_tokens=4)])[0].out
    assert len(seen) == 1 and math.isfinite(seen[0]) and len(out) == 4
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules
                   if sys.modules[m] is not None)
    return seen[0], np.asarray(out).tolist()
"""

_MESH_WITHOUT_JAX = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import mesh_rank
from repro_torch.launch.mesh import spawn
res = spawn(mesh_rank.rank, 2, device="cpu", threads=1, timeout=200)
assert res[0] == res[1], res
print("mesh trained and served", res[0])
"""


def test_port_trains_and_serves_on_a_mesh_with_jax_blocked(tmp_path):
    """Two gloo ranks on the CPU, JAX and the reference blocked in each."""
    (tmp_path / "mesh_rank.py").write_text(_MESH_RANK)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(tmp_path)]))
    res = subprocess.run([sys.executable, "-c", _MESH_WITHOUT_JAX], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh trained and served" in res.stdout
