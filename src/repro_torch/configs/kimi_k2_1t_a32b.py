"""kimi-k2-1t-a32b — trillion-parameter MoE [arXiv:2501 Kimi K2 paper table].

61L, d_model=7168, 64H (GQA kv=8), vocab=163840; MoE: 384 routed experts
(top-8, expert d_ff=2048) + 1 shared expert; first layer dense (d_ff=18432).
Pure full attention -> long_500k cell skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,  # d_model / n_heads
    d_ff=18432,  # the single leading dense layer
    vocab=163840,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=1,
    rope_theta=50_000.0,
    fsdp=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, n_experts=8, experts_per_token=2,
        n_shared_experts=1, moe_d_ff=64, first_dense_layers=1,
        fsdp=False, remat="none",
    )
