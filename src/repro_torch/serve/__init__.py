from .cache import (CacheBackend, RecurrentStateCache, RingPagedKVCache,
                    make_cache)
from .engine import Engine, EngineConfig
from .sampling import SamplingParams, filtered_logits, greedy_batch, sample_batch
from .scheduler import Request, Scheduler, SlotState
from .speculative import SpecDecoder
from .telemetry import MetricsRegistry, Telemetry, UndeclaredMetric

__all__ = [
    "CacheBackend",
    "Engine",
    "EngineConfig",
    "MetricsRegistry",
    "RecurrentStateCache",
    "Request",
    "RingPagedKVCache",
    "SamplingParams",
    "Scheduler",
    "SlotState",
    "SpecDecoder",
    "Telemetry",
    "UndeclaredMetric",
    "filtered_logits",
    "greedy_batch",
    "make_cache",
    "sample_batch",
]
