"""rwkv6-7b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].

32L, d_model=4096, d_ff=14336 (= 3.5*d channel-mix hidden), vocab=65536.
Sub-quadratic: runs the long_500k cell (O(1)-state decode).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads = d_model / ssm_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    ssm_head_dim=64,
    ssm_chunk=64,
    wkv_lora=64,
    fsdp=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=448,
        vocab=512, ssm_head_dim=32, wkv_lora=8, ssm_chunk=16,
        head_dim=32, fsdp=False, remat="none",
    )
