"""Model configuration covering every assigned architecture family (the
port's own copy of ``repro/models/config.py``, held field for field).

One frozen dataclass drives parameter shapes, sharding specs, and the
forward/prefill/decode programs. Families:

  dense   — llama3.2-1b, qwen2-1.5b, deepseek-7b, starcoder2-15b
  moe     — kimi-k2 (384e top-8), deepseek-v3 (MLA, 1 shared + 256 routed)
  ssm     — rwkv6-7b (attention-free, data-dependent decay)
  hybrid  — zamba2-1.2b (Mamba2 + shared attention block)
  vlm     — llama-3.2-vision-90b (interleaved cross-attention layers)
  audio   — whisper-large-v3 (encoder-decoder, mel-frame stub frontend)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False  # qwen2
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert ffn width
    first_dense_layers: int = 0  # deepseek-v3: leading dense layers
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    mtp: bool = False  # multi-token-prediction auxiliary head

    # --- SSM / hybrid ---
    ssm_state: int = 0  # mamba2 state size N
    ssm_head_dim: int = 64  # P (mamba2) / wkv head dim (rwkv6)
    ssm_chunk: int = 64  # chunked-scan block length
    attn_every: int = 0  # zamba2: shared attn block after every k ssm layers
    wkv_lora: int = 64  # rwkv6 data-dependent decay LoRA rank

    # --- VLM ---
    cross_attn_every: int = 0  # every Nth layer cross-attends (vlm/audio dec)
    n_frontend_tokens: int = 0  # patches (vlm) / frames (audio) from the stub

    # --- audio enc-dec ---
    encoder_layers: int = 0

    # --- numerics / policy ---
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    scan_layers: bool = True  # lax.scan over homogeneous layer stacks
    fsdp: bool = False  # shard params/optimizer over the data axis
    seq_shard: bool = False  # sequence-parallel activation sharding
    attn_impl: str = "naive"  # naive | flash (the hand-written CUDA kernel)
    # kept so configs round-trip with repro; the CUDA kernel picks its own
    # tiles and its result does not depend on these
    flash_block_q: int = 512
    flash_block_k: int = 512
    moe_impl: str = "gspmd"  # gspmd | ep_manual (shard_map EP, §Perf)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
        if self.family == "moe":
            assert self.n_experts > 0 and self.experts_per_token > 0

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode (O(1) state): ssm + hybrid families."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            per = _rwkv6_layer_params(self)
            return embed + self.n_layers * per
        if self.family == "hybrid":
            per = _mamba2_layer_params(self)
            shared = _attn_params(self) + 2 * d * self.d_ff + d * self.d_ff
            return embed + self.n_layers * per + shared
        attn = _attn_params(self)
        ffn_dense = 3 * d * self.d_ff
        if self.family == "moe":
            ffn_moe = 3 * d * self.moe_d_ff * self.n_experts
            ffn_shared = 3 * d * self.moe_d_ff * self.n_shared_experts
            router = d * self.n_experts
            n_moe = self.n_layers - self.first_dense_layers
            body = (
                self.n_layers * attn
                + self.first_dense_layers * ffn_dense
                + n_moe * (ffn_moe + ffn_shared + router)
            )
            return embed + body
        n_cross = self.n_layers // self.cross_attn_every if self.cross_attn_every else 0
        enc = self.encoder_layers * (attn + ffn_dense) if self.encoder_layers else 0
        return embed + self.n_layers * (attn + ffn_dense) + n_cross * attn + enc

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: routed top-k only)."""
        if self.family != "moe":
            return self.n_params
        d = self.d_model
        ffn_active = 3 * d * self.moe_d_ff * (
            self.experts_per_token + self.n_shared_experts
        )
        ffn_all = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
        n_moe = self.n_layers - self.first_dense_layers
        return self.n_params - n_moe * (ffn_all - ffn_active)


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.use_mla:
        rh = cfg.rope_head_dim
        return (
            d * cfg.q_lora_rank
            + cfg.q_lora_rank * h * (hd + rh)
            + d * (cfg.kv_lora_rank + rh)
            + cfg.kv_lora_rank * h * (hd + hd)
            + h * hd * d
        )
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def _rwkv6_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    lora = cfg.wkv_lora
    # time-mix: r,k,v,g,o projections + decay/mix LoRAs; channel-mix: 2 mats
    return 5 * d * d + 6 * 2 * d * lora + 2 * d * int(d * 3.5)


def _mamba2_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_inner = 2 * d
    n = cfg.ssm_state
    heads = d_inner // cfg.ssm_head_dim
    return d * (2 * d_inner + 2 * n + heads) + d_inner * d + 3 * d_inner


# ---------------------------------------------------------------------------
# Input shape sets (the assignment's per-arch shapes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
