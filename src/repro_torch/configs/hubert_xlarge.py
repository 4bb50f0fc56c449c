"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447; unverified].

48L d_model=1280 16H (kv=16, i.e. full MHA) d_ff=5120 vocab=504 (masked-unit
prediction codebook). Modality frontend is a STUB: data.make_batch provides
precomputed 512-d frame embeddings. Encoder-only => decode shapes skipped.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionSpec

ARCH_ID = "hubert-xlarge"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hubert",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    causal=False,
    norm="layernorm",
    act="gelu",
    pos="learned",
    max_seq=32768,
    frontend="audio_frames",
    frontend_dim=512,
    tie_embeddings=True,
    attention=AttentionSpec(kind="mra2", block_size=128, blocks_per_row=4),
    remat="full",
    scan_layers=True,
)


def smoke():
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, kv_heads=4, head_dim=16,
        d_ff=128, vocab=64, max_seq=512, frontend_dim=32,
        attention=AttentionSpec(kind="mra2", block_size=16, blocks_per_row=2),
        remat="none",
        scan_layers=False,
    )
