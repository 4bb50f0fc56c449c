"""What the per-layer readers (``bench/metrics/<name>.py``) share. Each
returns None where its run holds nothing for it to read."""
from __future__ import annotations

from .trace import device_s
from .work import BF16_FLOP_PER_S


def dispatch_ms(run, kind: str):
    """Mean wall ms of the engine's ``kind`` dispatches in the window: the
    exact total of its telemetry histogram over its dispatch counter."""
    n = run.layer_inputs.get(f"{kind}_n")
    if not n:
        return None
    return 1e3 * run.layer_inputs[f"{kind}_s"] / n


def mfu(run):
    """Model operations of the window's work over its wall time at the
    bf16 peak, in %."""
    flops = run.layer_inputs.get("model_flops")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops / (run.window_s * BF16_FLOP_PER_S)


def roofline(run, calls: tuple, kernels: tuple):
    """Summed least time of the recorded ``calls`` over the device time of
    the kernels whose names start with ``kernels``, in %."""
    if run.summary is None or run.recorder is None:
        return None
    least = [run.recorder.least_s(c) for c in calls]
    if all(v is None for v in least):
        return None
    dev = device_s(run.summary, *kernels)
    if dev <= 0:
        return None
    return 100.0 * sum(v for v in least if v is not None) / dev


def idle_share(run):
    """Share of the traced window in which no kernel ran, in %."""
    s = run.summary
    if s is None or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
