"""Shared building blocks (``repro/models/layers.py:27-171``): norms, RoPE,
the SwiGLU MLP, initializers, embeddings.

Parameters live in ``nn.Module``s whose attribute names are ``repro``'s
parameter-tree keys (``scale``, ``w_gate``, ``tok``, ...), so the functions
below read ``p.<key>`` where ``repro`` reads ``p["<key>"]``. The numerics are
``repro``'s: ``rms_norm`` and ``apply_rope`` work in float32 and cast back to
the input dtype at the end; RoPE rotates split halves, not interleaved
pairs. The sharding helpers (``ShardCtx``, ``*_specs``) wait for the
multi-GPU slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter; ``init_params`` or the converter fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def ninit(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``repro``'s ``ninit``: a float32 normal draw times ``scale``, cast to
    ``dtype``, on the generator's device."""
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = param((d,), dtype, device)


def rms_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``repro`` always uses eps = 1e-5 here (``cfg.norm_eps`` is never
    passed, ROADMAP Queue 3); so does the port."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., L, H, hd); positions: broadcastable to (..., L)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., L, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., L, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = param((d, d_ff), dtype, device)
        self.w_up = param((d, d_ff), dtype, device)
        self.w_down = param((d_ff, d), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d, d_ff = self.w_gate.shape
        self.w_gate.copy_(ninit(generator, (d, d_ff), d**-0.5, self.w_gate.dtype))
        self.w_up.copy_(ninit(generator, (d, d_ff), d**-0.5, self.w_up.dtype))
        self.w_down.copy_(ninit(generator, (d_ff, d), d_ff**-0.5, self.w_down.dtype))


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ p.w_gate)
    up = x @ p.w_up
    return (gate * up) @ p.w_down


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.tok = param((cfg.vocab, cfg.d_model), dtype, device)
        if not cfg.tie_embeddings:
            self.head = param((cfg.d_model, cfg.vocab), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        self.tok.copy_(ninit(generator, self.tok.shape, 0.02, self.tok.dtype))
        if not cfg.tie_embeddings:
            self.head.copy_(ninit(generator, self.head.shape, cfg.d_model**-0.5,
                                  self.head.dtype))


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p.tok)


def unembed(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p.tok.T if cfg.tie_embeddings else p.head
    return h @ w
