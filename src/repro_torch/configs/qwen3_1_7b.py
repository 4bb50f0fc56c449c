"""qwen3-1.7b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "qwen3-1.7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    kv_heads=8,
    d_ff=6144,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    attention=AttentionSpec(kind="mra2", block_size=128, blocks_per_row=4,
                            decode_blocks=16),
    scan_layers=True,
)


def smoke():
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        attention=AttentionSpec(kind="mra2", block_size=16, blocks_per_row=2,
                                decode_blocks=2),
        scan_layers=False,
    )
