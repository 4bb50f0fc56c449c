"""On the card, at the cells' own sizes: a training step that leaves half
of the batch out (the mean taken over the rest) fails the check. Run with
``python -m pytest -m cuda -s bench/tests/test_bench_card.py``; each case
prints its readings. Skips without a card."""
import json

import pytest

import benchutil  # noqa: F401  (puts the harness on the path)
from mrabench import cli

TRAIN = ("qwen3-1.7b.train-4k", "granite-moe-3b-a800m.train-4k")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (3300000001, 3300000002, 3300000003))
@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_fails_on_the_card(cuda_device, monkeypatch, cell, seed):
    from repro_torch.models import transformer

    real = transformer.loss_fn

    def half(params, cfg, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return real(params, cfg, {k: v[:n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(transformer, "loss_fn", half)
    out = cli.execute(cli.load_cell(cell), seed=seed, seconds=1,
                      trace=False, device=cuda_device)
    print(json.dumps({"cell": cell, "seed": seed, "checks": out["checks"],
                      "notes": out["notes"]}))
    assert not out["correct"]
