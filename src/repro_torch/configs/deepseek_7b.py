"""deepseek-7b — llama-architecture dense [arXiv:2401.02954].

30L, d_model=4096, 32H (kv=32, MHA), d_ff=11008, vocab=102400.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    rope_theta=10_000.0,
    fsdp=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, head_dim=32, fsdp=False, remat="none",
    )
