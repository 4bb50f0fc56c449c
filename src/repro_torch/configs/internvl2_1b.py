"""internvl2-1b — InternViT + qwen2-0.5b-style LLM [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The vision frontend
is a STUB: data.make_batch provides precomputed 1024-d patch embeddings
(InternViT output), projected and prepended to the text.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "internvl2-1b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="internvl",
    num_layers=24,
    d_model=896,
    num_heads=14,
    kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e6,
    frontend="vision_patches",
    frontend_dim=1024,
    num_patches=256,
    attention=AttentionSpec(kind="mra2", block_size=128, blocks_per_row=4,
                            decode_blocks=16),
    remat="full",
    scan_layers=True,
)


def smoke():
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, frontend_dim=32, num_patches=8,
        attention=AttentionSpec(kind="mra2", block_size=16, blocks_per_row=2,
                                decode_blocks=2),
        remat="none",
        scan_layers=False,
    )
