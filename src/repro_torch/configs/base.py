"""Model and input-shape configuration schema of the ported families.

Port of ``repro/configs/base.py``: the ``ModelConfig`` fields the dense and
MoE decoders, the hubert encoder, the internvl VLM, the rwkv6 recurrent LM
and the recurrentgemma hybrid read (``MoESpec``, the ``moe`` /
``moe_dispatch`` fields, the frontend, learned-position, layernorm and gelu
fields, rwkv6's head size, chunk and decay LoRA width, and recurrentgemma's
block pattern, local window, RG-LRU width and conv width, all with the
reference's defaults), and the ``ShapeCfg`` input-shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.attention import AttentionSpec


# the model families of the port (all of the reference's)
FAMILIES = ("dense", "moe", "hubert", "internvl", "rwkv6", "recurrentgemma")


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Routed experts of an MoE FFN: ``top_k`` of ``num_experts`` experts of
    width ``d_ff_expert`` per token, ``capacity_factor`` x the even share of
    assignments per expert buffer, and the aux losses' coefficients."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    causal: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu (tanh approximation)
    pos: str = "rope"  # rope | learned | none
    rope_theta: float = 10000.0
    max_seq: int = 8192  # learned-positions table size
    moe: Optional[MoESpec] = None
    attention: AttentionSpec = dataclasses.field(default_factory=AttentionSpec)
    # serving-kernel tile shape for every dispatch: "auto" picks per call
    # (decode -> latency, prefill chunks -> throughput)
    attn_kernel_mode: str = "auto"
    # modality frontends (stubs, as in the reference: precomputed frame or
    # patch embeddings in, projected to d_model)
    frontend: Optional[str] = None  # audio_frames | vision_patches
    frontend_dim: int = 512
    num_patches: int = 0
    # recurrentgemma: the repeating block pattern (empty: rglru, rglru,
    # local), the local layers' sliding window, the RG-LRU width (0: d_model)
    # and its causal conv's width
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 2048
    lru_width: int = 0
    conv1d_width: int = 4
    # rwkv6: head size, wkv chunk (keeps the factored chunk form exact in
    # fp32) and the data-dependent decay's LoRA width
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 16
    decay_lora: int = 64
    pad_vocab_to: int = 256  # embedding table padded so vocab shards over TP
    pad_attn_heads_to: int = 0  # query heads padded (masked) to a multiple
    # MoE token dispatch under a mesh (models/moe.py): "psum" (replicated
    # tokens, each model rank its expert slice, or the expert d_ff slice
    # when the experts do not divide) or "a2a" (sequence-sharded tokens
    # exchanged with the expert owners); one device runs every expert
    moe_dispatch: str = "psum"
    param_dtype: str = "float32"
    activ_dtype: str = "bfloat16"
    # the reference keeps this config's layers stacked as (L, ...) arrays;
    # params_from_jax reads that layout (the port always holds a layer list)
    scan_layers: bool = False
    # activation recomputation in training: "none" | "full" (each layer's
    # forward runs again in the backward) | "dots" (products kept)
    remat: str = "none"
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
    def kv_slots(self) -> int:
        """KV slot count used by full-sequence attention (expanded for TP)."""
        t = self.pad_attn_heads_to
        if t <= 0 or (self.num_heads % t == 0
                      and self.kv_heads % min(t, self.num_heads) == 0):
            return self.kv_heads
        return min(t, self.padded_heads)

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adt(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One input-shape cell: sequence length, global batch, and the
    reference's name and kind (train | prefill | decode). The fields the
    data pipeline reads come first, so ``ShapeCfg(seq, batch)`` is a
    training shape."""

    seq_len: int
    global_batch: int
    name: str = ""
    kind: str = "train"


# the reference's four cells (repro/configs/base.py), its exact values
SHAPES = {
    "train_4k": ShapeCfg(4096, 256, "train_4k", "train"),
    "prefill_32k": ShapeCfg(32768, 32, "prefill_32k", "prefill"),
    "decode_32k": ShapeCfg(32768, 128, "decode_32k", "decode"),
    "long_500k": ShapeCfg(524288, 1, "long_500k", "decode"),
}
