"""Shared building blocks (``repro/models/layers.py:27-171``): norms, RoPE,
the SwiGLU MLP, initializers, embeddings, and the sharding helpers.

Parameters live in ``nn.Module``s whose attribute names are ``repro``'s
parameter-tree keys (``scale``, ``w_gate``, ``tok``, ...), so the functions
below read ``p.<key>`` where ``repro`` reads ``p["<key>"]``. The numerics are
``repro``'s: ``rms_norm`` and ``apply_rope`` work in float32 and cast back to
the input dtype at the end; RoPE rotates split halves, not interleaved
pairs.

Sharding: every parameter module has a ``*_specs`` function returning, per
parameter key, a spec: a tuple with one entry per dim, each an axis name, a
tuple of axis names (sharded over their row-major product) or ``None``
(replicated), as ``repro``'s ``PartitionSpec``. A dim is sharded over an
axis only when divisible (``shard_if``), so heads that do not divide the
model axis (qwen2's 12, whisper's 20) stay replicated. On a mesh step
(``models.parallel``) the MLP is tensor-parallel over ``d_ff`` and the
embedding and the logits are vocab-parallel where the specs shard them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel as par
from repro_torch.models.config import ModelConfig

# mesh axis names (fixed by launch/mesh.py)
POD, DATA, MODEL = "pod", "data", "model"


def P(*dims) -> tuple:
    """A spec: one entry per dim (``repro``'s ``PartitionSpec(*dims)``)."""
    return tuple(dims)


def shard_if(dim: int, size: int, axis: str) -> Optional[str]:
    """Shard `dim` over `axis` (of `size` devices) only when divisible."""
    return axis if dim % size == 0 and dim >= size else None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh-dependent context for building spec trees."""

    model_size: int = 16
    fsdp: bool = False

    def heads(self, n: int) -> Optional[str]:
        return shard_if(n, self.model_size, MODEL)

    def ff(self, n: int) -> Optional[str]:
        return shard_if(n, self.model_size, MODEL)

    def data(self, n: int) -> Optional[str]:
        # FSDP shards a replicated-over-model dim over the data axis; repro
        # tests n % 16, not the data axis's size (kept: a spec'd dim the
        # data axis does not divide raises at placement)
        return DATA if self.fsdp and n % 16 == 0 else None


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


def rmsnorm_specs() -> dict:
    return {"scale": P(None)}


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
    tp_keys = ("w_gate", "w_up", "w_down")

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


def mlp_specs(ctx: ShardCtx, d: int, d_ff: int) -> dict:
    m = ctx.ff(d_ff)
    dd = ctx.data(d)
    return {"w_gate": P(dd, m), "w_up": P(dd, m), "w_down": P(m, dd)}


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU. On a mesh step that shards ``d_ff`` over the model axis,
    column-parallel ``w_gate`` / ``w_up`` and row-parallel ``w_down``: the
    replicated input enters through ``copy`` (its gradient summed over the
    model axis) and the partial outputs are summed over it."""
    tp = par.tp_group(p, "w_gate")
    if tp is not None:
        x = par.copy_to(x, tp)
    gate = F.silu(x @ p.w_gate)
    up = x @ p.w_up
    y = (gate * up) @ p.w_down
    return y if tp is None else par.reduce_from(y, tp)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    tp_keys = ("tok", "head")

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


def embed_specs(ctx: ShardCtx, cfg: ModelConfig) -> dict:
    v_shard = ctx.heads(cfg.vocab)  # vocab over model axis
    p = {"tok": P(v_shard, ctx.data(cfg.d_model))}
    if not cfg.tie_embeddings:
        p["head"] = P(ctx.data(cfg.d_model), v_shard)
    return p


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings. Vocab-parallel on a mesh step that shards the
    vocab: each model rank looks up the ids in its range (the others give
    zero rows) and the rows are summed over the model axis."""
    tp = par.tp_group(p, "tok")
    if tp is None:
        return F.embedding(tokens.long(), p.tok)
    lo = tp.index * p.tok.shape[0]
    ids = tokens.long() - lo
    mine = (ids >= 0) & (ids < p.tok.shape[0])
    rows = F.embedding(torch.where(mine, ids, torch.zeros_like(ids)), p.tok)
    return par.reduce_from(rows * mine[..., None].to(rows.dtype), tp)


def unembed(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits; on a mesh step that shards the vocab, this model rank's
    vocab columns (``par.vocab_lse_gold`` and ``par.gather_vocab`` read
    them)."""
    w = p.tok.T if cfg.tie_embeddings else p.head
    tp = par.tp_group(p, "tok")
    return (h if tp is None else par.copy_to(h, tp)) @ w
