"""The port's example programs (``python -m repro_torch.examples.<name>``) at
their smallest sizes with ``--device cpu``.

Where an example prints the same quantity as the reference's, it
matches within 1e-4: ``quickstart``'s MRA-2 relative errors against exact
softmax (the reference's ``mra2_attention`` on the same numpy draws), and
``approx_demo``'s Fig. 1 errors (the reference's
``benchmarks/approx_error.fig1_matrix_level``). ``train_lm`` trains its
small preset one step per attention kind; ``serve_decode`` serves its four
requests (MRA-2 and exact, greedy; a recurrent arch; sampling).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import MraConfig as JMraConfig
from repro.core import full_attention as j_full
from repro.core import mra2_attention as j_mra2
from repro_torch.examples import approx_demo, quickstart, serve_decode, train_lm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.approx_error import fig1_matrix_level  # noqa: E402


def _j_rel(bpr, q, k, v, ref):
    o = jax.jit(lambda q, k, v: j_mra2(q, k, v, JMraConfig(
        block_size=32, blocks_per_row=bpr)))(q, k, v)
    return float(jnp.linalg.norm((o - ref).astype(jnp.float32))
                 / jnp.linalg.norm(ref.astype(jnp.float32)))


def test_quickstart_matches_the_reference():
    got = quickstart.main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    B, Hq, Hkv, N, D = 2, 8, 2, 1024, 64
    q = jnp.asarray(rng.standard_normal((B, Hq, N, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, Hkv, N, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, Hkv, N, D)), jnp.bfloat16)
    ref = j_full(q, k, v)
    assert abs(got["rel_error"] - _j_rel(4, q, k, v, ref)) < 1e-4
    for bpr, (frac, err) in got["sweep"].items():
        assert frac == pytest.approx(bpr / 32)
        assert abs(err - _j_rel(bpr, q, k, v, ref)) < 1e-4, bpr
    assert got["dispatch"] == ((2, 8, 1024, 64), "torch.bfloat16")
    assert got["kernel_diff"] == 0.0 and got["kernel_launches"] == 0


def test_approx_demo_matches_the_reference():
    got = approx_demo.main(["--device", "cpu", "--seeds", "2"])
    for seed, errs in enumerate(got["errors"]):
        want = fig1_matrix_level(np.random.default_rng(seed))
        np.testing.assert_allclose(errs, want, rtol=0, atol=1e-4)
    assert got["mean"][0] < got["mean"][1] < got["mean"][2]


def test_train_lm_small_preset_trains_both_kinds():
    curves = train_lm.main(["--device", "cpu", "--steps", "1",
                            "--attention", "mra2,full"])
    assert set(curves) == {"mra2", "full"}
    for hist in curves.values():
        assert len(hist) == 1 and np.isfinite(hist).all()
        assert abs(hist[0] - np.log(8192)) < 0.5  # untrained: ~ln(vocab)
    assert train_lm.parse_dims("2x4") == (2, 4)
    assert train_lm.parse_dims("4") == (4, 1)


@pytest.mark.parametrize("args", [
    [], ["--temperature", "0.8", "--seed", "7"], ["--spec-k", "2"],
    ["--arch", "rwkv6-7b"], ["--mesh", "2x2"]],
    ids=["greedy", "sampled", "spec", "rwkv6", "mesh2x2"])
def test_serve_decode_serves_four_requests(args):
    out = serve_decode.main(["--device", "cpu", "--new-tokens", "4", *args])
    streams = out["streams"]
    for kind, by_len in streams.items():
        assert sorted(by_len) == [5, 7, 9, 13], kind
        assert all(len(t) == 4 for t in by_len.values())
    if "mra2" in streams and not args:
        assert out["identical"] == 4  # the reference's smoke run agrees too
    if "--mesh" in args:  # four gloo ranks serve the one-device streams
        one = serve_decode.main(["--device", "cpu", "--new-tokens", "4"])
        assert streams == one["streams"]


def test_examples_run_as_modules():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.approx_demo", "--device",
         "cpu", "--seeds", "1"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "claim check" in out.stdout
