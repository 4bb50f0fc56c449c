"""granite-moe-3b-a800m — IBM Granite MoE [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512(per expert) vocab=49155,
MoE 40 experts top-8. The port serves it whole on one card (all 40
experts local, ``moe_dispatch="psum"``); its attention runs the CUDA
kernels at head dim 64, block 128.
"""
from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "granite-moe-3b-a800m"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoESpec(num_experts=40, top_k=8, d_ff_expert=512),
    attention=AttentionSpec(kind="mra2", block_size=128, blocks_per_row=4,
                            decode_blocks=16),
    remat="full",
    scan_layers=True,
)


def smoke():
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=32, vocab=512,
        moe=MoESpec(num_experts=5, top_k=2, d_ff_expert=32, capacity_factor=2.0),
        attention=AttentionSpec(kind="mra2", block_size=16, blocks_per_row=2,
                                decode_blocks=2),
        remat="none",
        scan_layers=False,
    )
