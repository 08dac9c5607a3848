"""llama-3.2-vision-90b — cross-attention image layers
[hf:meta-llama/Llama-3.2-90B-Vision].

100L total = 80 self-attention + 20 cross-attention (every 5th layer),
d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256. The vision tower is a
STUB: the caller passes precomputed patch embeddings (B, 1600, 8192).
Pure full attention -> long_500k cell skipped (DESIGN.md).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,  # counted as 80 self + 20 cross via cross_attn_every=5
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_frontend_tokens=1600,
    fsdp=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=10, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, cross_attn_every=5, n_frontend_tokens=16,
        fsdp=False, remat="none",
    )
