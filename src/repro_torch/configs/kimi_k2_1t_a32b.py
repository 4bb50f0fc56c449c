"""kimi-k2-1t-a32b — Kimi K2 trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(per expert) vocab=163840,
MoE 384 experts top-8. At full width (head dim 112, about 1 T
parameters) it does not fit one card; one layer does, in bf16 weights
(38.8 GB), and runs the kernels at (head dim, block) = (112, 128). Its
smoke config (D = b = 16) runs on the CPU and on the card.
"""
from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "kimi-k2-1t-a32b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,  # 7168 / 64
    moe=MoESpec(num_experts=384, top_k=8, d_ff_expert=2048),
    attention=AttentionSpec(kind="mra2", block_size=128, blocks_per_row=4,
                            decode_blocks=16),
    remat="full",
    scan_layers=True,
)


def smoke():
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=32, vocab=512,
        moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=2.0),
        attention=AttentionSpec(kind="mra2", block_size=16, blocks_per_row=2,
                                decode_blocks=2),
        remat="none",
        scan_layers=False,
    )
