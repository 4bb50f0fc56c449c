"""Model configuration schema for the dense family.

Port of ``repro/configs/base.py``: the ``ModelConfig`` fields the dense
decoder reads. MoE, recurrent, encoder and vision fields come with their
families.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.attention import AttentionSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the only family served yet)
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"
    act: str = "swiglu"
    pos: str = "rope"
    rope_theta: float = 10000.0
    attention: AttentionSpec = dataclasses.field(default_factory=AttentionSpec)
    # serving-kernel tile shape for every dispatch: "auto" picks per call
    # (decode -> latency, prefill chunks -> throughput)
    attn_kernel_mode: str = "auto"
    pad_vocab_to: int = 256  # embedding table padded so vocab shards over TP
    pad_attn_heads_to: int = 0  # query heads padded (masked) to a multiple
    param_dtype: str = "float32"
    activ_dtype: str = "bfloat16"
    # the reference keeps this config's layers stacked as (L, ...) arrays;
    # params_from_jax reads that layout (the port always holds a layer list)
    scan_layers: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_spec(self) -> AttentionSpec:
        """cfg.attention with the model-level kernel mode applied."""
        if self.attn_kernel_mode == "auto":
            return self.attention
        return dataclasses.replace(self.attention,
                                   kernel_mode=self.attn_kernel_mode)

    @property
    def padded_vocab(self) -> int:
        m = max(self.pad_vocab_to, 1)
        return -(-self.vocab // m) * m

    @property
    def padded_heads(self) -> int:
        """Query-head count after TP padding (== num_heads when disabled)."""
        t = self.pad_attn_heads_to
        if t <= 0 or self.num_heads % t == 0:
            return self.num_heads
        return -(-self.num_heads // t) * t

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adt(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
