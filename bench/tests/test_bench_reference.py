"""The plain reference against the program's plain route (its CPU
twins) at small sizes, everything in float32."""
import numpy as np
import pytest
import torch

import benchutil
from mrabench import cli, weights
from mrabench.reference.decoder import Decoder
from mrabench.reference.mra_serve import served_logits
from mrabench.reference.train import loss as ref_loss


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these small runs gain nothing from more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_served_logits_match_the_engine(monkeypatch):
    """Logits the engine sampled from (chunked prefill, then decode over
    the paged cache, prompts past the selection budget) against the
    reference's at the same positions."""
    from repro_torch.serve import engine as eng_mod
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    spec = benchutil.small_spec("qwen3-1.7b.serve-longdoc",
                                activ_dtype="float32")
    model = spec["config"]["model"]
    params, _ = weights.make(model, 11, "cpu")
    seen = []
    real = eng_mod.sample_batch

    def record(logits, *a, **kw):
        seen.append(logits.detach().clone())
        return real(logits, *a, **kw)

    monkeypatch.setattr(eng_mod, "sample_batch", record)
    eng = Engine(cli.model_config(model), params,
                 EngineConfig(slots=1, max_len=128, chunk=16), device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, model["vocab"], 90).astype(np.int32)
    (req,) = eng.run([Request(prompt, max_new_tokens=6)])
    got = torch.stack([s[0, :model["vocab"]] for s in seen])
    toks = torch.from_numpy(np.concatenate([prompt, req.out[:-1]])).long()
    at = torch.arange(len(prompt) - 1, len(prompt) + 5)
    want = served_logits(Decoder(model, params), toks, at, block=16, m=2)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_training_loss_and_gradients_match_the_program():
    from repro_torch.models.registry import get_model

    for cell in ("qwen3-1.7b.train-4k", "granite-moe-3b-a800m.train-4k"):
        spec = benchutil.small_spec(cell, activ_dtype="float32", remat="none")
        model = spec["config"]["model"]
        cfg = cli.model_config(model)
        params, _ = weights.make(model, 5, "cpu")
        leaves = [p.requires_grad_(True) for _, p in weights.leaf_paths(params)]
        toks = torch.randint(0, model["vocab"], (2, 33),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        total, metrics = get_model(cfg).loss_fn(params, cfg, batch)
        g_prog = torch.autograd.grad(total, leaves)
        total_r, mean_r = ref_loss(Decoder(model, params), batch["tokens"],
                                   batch["targets"])
        g_ref = torch.autograd.grad(total_r, leaves)
        assert abs(float(metrics["loss"].detach()) - float(mean_r.detach())) < 1e-4
        assert abs(float(total.detach()) - float(total_r.detach())) < 1e-4
        for a, b in zip(g_prog, g_ref):
            scale = max(float(b.abs().max()), 1e-6)
            assert float((a - b).abs().max()) <= 1e-3 * scale
