from .cache import CacheBackend, RingPagedKVCache
from .engine import Engine, EngineConfig
from .sampling import SamplingParams, filtered_logits, greedy_batch, sample_batch
from .scheduler import Request, Scheduler, SlotState

__all__ = [
    "CacheBackend",
    "Engine",
    "EngineConfig",
    "Request",
    "RingPagedKVCache",
    "SamplingParams",
    "Scheduler",
    "SlotState",
    "filtered_logits",
    "greedy_batch",
    "sample_batch",
]
