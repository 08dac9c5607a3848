"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242].

38L mamba2 (ssm_state=64) with one weight-shared attention+MLP block applied
after every 6 mamba layers; d_model=2048, 32H (kv=32), d_ff=8192, vocab=32000.
Hybrid -> runs the long_500k cell (O(1)-state decode).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=64,
    attn_every=6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, ssm_state=16, ssm_head_dim=32, ssm_chunk=16,
        attn_every=3, remat="none",
    )
