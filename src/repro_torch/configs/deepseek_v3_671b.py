"""deepseek-v3-671b — MLA + 1 shared / 256 routed top-8 + MTP [arXiv:2412.19437].

61L, d_model=7168, 128 MLA heads (q_lora=1536, kv_lora=512, rope_dim=64),
vocab=129280; experts d_ff=2048; first 3 layers dense (d_ff=18432); MTP head.
The assignment line's "GQA kv=128" is superseded by its own MLA annotation —
we implement MLA as published, with compressed-latent decode (DESIGN.md).
Pure full attention -> long_500k cell skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # leading dense layers
    vocab=129280,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    mtp=True,
    rope_theta=10_000.0,
    fsdp=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, n_experts=8, experts_per_token=2,
        n_shared_experts=1, moe_d_ff=64, first_dense_layers=1,
        q_lora_rank=48, kv_lora_rank=32, rope_head_dim=16,
        fsdp=False, remat="none",
    )
