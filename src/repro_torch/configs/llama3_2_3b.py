"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "llama3.2-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=128,
    rope_theta=5e5,
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
