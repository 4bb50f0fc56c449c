"""The check that decides ``correct`` fails where it must: the float8
control in the program's place, and each fault the cells can have,
planted under a run that otherwise goes as on the card (the look for a
card skipped, small sizes, the configuration files' limits)."""
import time
import types

import pytest
import torch

import benchutil
from mrabench import cli, weights
from mrabench.reference.decoder import Cast, Decoder
from mrabench.reference.mra_serve import served_logits
from mrabench.reference.train import loss as ref_loss

SERVE = "qwen3-1.7b.serve-longdoc"
TRAIN = ("qwen3-1.7b.train-4k", "granite-moe-3b-a800m.train-4k")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these small runs gain nothing from more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(spec, seed=2**31 + 7):
    return cli.execute(spec, seed=seed, seconds=0.2, trace=False,
                       device="cpu")


def _sound(cell):
    return benchutil.small_spec(cell, activ_dtype="float32")


@pytest.mark.parametrize("cell", (SERVE,) + TRAIN)
def test_a_sound_run_is_correct(cell):
    out = _run(_sound(cell))
    assert out["correct"], out["checks"]


# ---- serving ------------------------------------------------------------- #
def _control_engine_run(self, requests):
    """Greedy decoding by the float8 reference, in the engine's place."""
    model = self.bench_model
    dec = Decoder(model, self.params, Cast("fp8"))
    att = model["attention"]
    for r in requests:
        toks = torch.from_numpy(r.prompt).long()
        stamps = []
        for _ in range(r.max_new_tokens):
            lg = served_logits(dec, toks, torch.tensor([len(toks) - 1]),
                               block=att["block_size"],
                               m=att["decode_blocks"])
            toks = torch.cat([toks, lg.argmax(-1)])
            stamps.append(time.perf_counter())
        r.out = toks[len(r.prompt):].numpy()
        r.trace = types.SimpleNamespace(token_times=stamps)
    return list(requests)


def test_serving_control_fails(monkeypatch):
    from repro_torch.serve import engine as eng_mod

    spec = _sound(SERVE)
    spec["config"]["model"].update(d_model=256, num_heads=8, kv_heads=4,
                                   head_dim=32, d_ff=512, vocab=4096)
    spec["traffic"].update(job_requests=3, output={"min": 3, "max": 4},
                           check={"served_tokens": 8})
    monkeypatch.setattr(eng_mod.Engine, "bench_model",
                        spec["config"]["model"], raising=False)
    monkeypatch.setattr(eng_mod.Engine, "run", _control_engine_run)
    assert not _run(spec)["correct"]


def test_serving_token_altered_fails(monkeypatch):
    from repro_torch.serve import engine as eng_mod

    real = eng_mod.sample_batch

    def altered(logits, *a, **kw):
        out = real(logits, *a, **kw)
        out[0] = (out[0] + 1) % kw["vocab"]
        return out

    monkeypatch.setattr(eng_mod, "sample_batch", altered)
    assert not _run(_sound(SERVE))["correct"]


def test_serving_requests_left_out_fail(monkeypatch):
    from repro_torch.serve import engine as eng_mod

    real = eng_mod.Engine.run
    monkeypatch.setattr(eng_mod.Engine, "run",
                        lambda self, reqs: real(self, reqs[: len(reqs) // 2]))
    out = _run(_sound(SERVE))
    assert out["failed"] > 0 and not out["correct"]


# ---- training ------------------------------------------------------------ #
def _control_step(model):
    from repro_torch.models.params import tree_unflatten

    def make(cfg, tc, optimizer, lr_fn, **kw):
        def step(params, state, batch):
            leaves = [p for _, p in weights.leaf_paths(params)]
            total, mean = ref_loss(Decoder(model, params, Cast("fp8")),
                                   batch["tokens"], batch["targets"])
            grads = torch.autograd.grad(total, leaves)
            params, state, gnorm = optimizer.update(
                tree_unflatten(params, list(grads)), state, params,
                lr_fn(state.step))
            return params, state, {"loss": mean.detach(), "grad_norm": gnorm}
        return step
    return make


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_fails(monkeypatch, cell):
    from repro_torch.train import loop

    spec = _sound(cell)
    # at d 64 the tied head's float8 rounding stays inside granite's limits
    spec["config"]["model"].update(d_model=256, num_heads=8, kv_heads=4,
                                   head_dim=32, d_ff=512, vocab=4096)
    monkeypatch.setattr(loop, "make_train_step",
                        _control_step(spec["config"]["model"]))
    assert not _run(spec)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_training_state_unchanged_fails(monkeypatch, cell):
    from repro_torch.optim import adamw

    def update(self, grads, state, params, lr, plan=None):
        gnorm = adamw.global_norm(list(weights.leaf_paths(grads)) and
                                  [g for _, g in weights.leaf_paths(grads)])
        return params, state._replace(step=state.step + 1), gnorm

    monkeypatch.setattr(adamw.AdamW, "update", update)
    assert not _run(_sound(cell))["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_training_half_batch_fails(monkeypatch, cell):
    from repro_torch.models import transformer

    real = transformer.loss_fn

    def half(params, cfg, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return real(params, cfg, {k: v[:n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(transformer, "loss_fn", half)
    assert not _run(_sound(cell))["correct"]
