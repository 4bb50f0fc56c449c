"""rwkv6-7b — Finch, data-dependent decay, attention-free [arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536. MRA does not apply (no attention
matrix); the model runs without it (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "rwkv6-7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="rwkv6",
    num_layers=32,
    d_model=4096,
    num_heads=64,   # 4096 / rwkv_head_dim (64)
    kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    rwkv_chunk=16,
    attention=AttentionSpec(kind="full"),  # unused: the family has none
    remat="full",
    scan_layers=True,
)


def smoke():
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, kv_heads=4, d_ff=128, vocab=512,
        rwkv_head_dim=16, rwkv_chunk=8, decay_lora=8, remat="none",
        scan_layers=False,
    )
