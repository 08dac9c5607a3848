"""whisper-large-v3 — encoder-decoder speech model [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280, 20H (kv=20), d_ff=5120,
vocab=51866. The conv mel frontend is a STUB: the caller passes
precomputed frame embeddings (B, 1500, 1280). Positional scheme adapted to
RoPE for the synthetic 32k decode cells (backbone-only per the assignment).
20 heads do not divide the 16-way model axis -> attention replicated under
TP. Pure full attention -> long_500k cell skipped.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder layers
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    n_frontend_tokens=1500,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512, head_dim=32,
        n_frontend_tokens=12, remat="none",
    )
