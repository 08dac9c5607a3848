"""starcoder2-15b — GQA + RoPE code model [arXiv:2402.19173].

40L, d_model=6144, 48H (GQA kv=4), d_ff=24576, vocab=49152.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    rope_theta=1_000_000.0,
    fsdp=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512, head_dim=32, fsdp=False, remat="none",
    )
