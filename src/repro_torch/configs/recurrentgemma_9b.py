"""recurrentgemma-9b — RG-LRU + local attention, 1:2 [arXiv:2402.19427; unverified].

38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000.
Block pattern (rglru, rglru, local). MRA applies to the local-attention
layers (cfg.attention.kind="mra2" routes them through the paper's scheme).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "recurrentgemma-9b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="recurrentgemma",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    lru_width=4096,
    act="gelu",
    attention=AttentionSpec(kind="local", local_window=2048),
    remat="full",
    scan_layers=True,
)


def smoke():
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, local_window=32, lru_width=64, remat="none",
        scan_layers=False,
        attention=AttentionSpec(kind="local", local_window=32),
    )
