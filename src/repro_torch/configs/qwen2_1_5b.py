"""qwen2-1.5b — GQA with QKV bias [arXiv:2407.10671].

28L, d_model=1536, 12H (GQA kv=2), d_ff=8960, vocab=151936.
Note: 12 heads do not divide the 16-way model axis -> attention weights are
replicated under TP (only the MLP shards); see DESIGN.md.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_ff=192,
        vocab=512, head_dim=32, remat="none",
    )
