"""GQA self-attention (``repro/models/attention.py``, the GQA half): train /
prefill over a full sequence, naive or flash, and single-token cached
decode.

Layouts and casts are ``repro``'s: activations (B, L, H, hd); scores in
float32; softmax weights cast to ``x.dtype`` before the value product; the
flash output cast to ``x.dtype`` before ``wo``. MLA and cross-attention
decode wait for later slices (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from collections import namedtuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dtype_of, ninit, param

NEG_INF = -1e30

TensorSpec = namedtuple("TensorSpec", "shape dtype")


class Attention(nn.Module):
    """GQA projections under ``repro``'s keys: wq (d, H, hd), wk / wv
    (d, KV, hd), wo (H, hd, d). (qwen2's ``qkv_bias`` waits for its config.)"""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param((d, h, hd), dtype, device)
        self.wk = param((d, kv, hd), dtype, device)
        self.wv = param((d, kv, hd), dtype, device)
        self.wo = param((h, hd, d), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        s = d**-0.5
        for w, scale in ((self.wq, s), (self.wk, s), (self.wv, s), (self.wo, (h * hd) ** -0.5)):
            w.copy_(ninit(generator, w.shape, scale, w.dtype))


def _project_qkv(p, x):
    q = torch.einsum("bld,dhk->blhk", x, p.wq)
    k = torch.einsum("bld,dhk->blhk", x, p.wk)
    v = torch.einsum("bld,dhk->blhk", x, p.wv)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B, L, H, hd); k: (B, S, KV, hd) -> (B, KV, G, L, S) float32 (the
    product in the input dtype, then divided by a float32 sqrt(hd))."""
    b, l, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, l, kvh, g, hd)
    root = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=q.device))
    return torch.einsum("blkgd,bskd->bkgls", qg, k).float() / root


def _gqa_out(weights, v, p):
    """weights: (B, KV, G, L, S); v: (B, S, KV, hd) -> (B, L, D)."""
    b, kvh, g, l, s = weights.shape
    ctx = torch.einsum("bkgls,bskd->blkgd", weights, v)
    ctx = ctx.reshape(b, l, kvh * g, v.shape[-1])
    return torch.einsum("blhd,hdk->blk", ctx, p.wo)


def _flash(q, k, v):
    """The causal flash kernel on (B, L, H, d)-layout tensors: the kernel
    reads the transposed views by stride, no copy."""
    out, _ = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
                             q.shape[-1] ** -0.5)
    return out.transpose(1, 2)


def apply_attention(p, cfg: ModelConfig, x, positions):
    """Full-sequence causal self-attention (train / prefill). x: (B, L, D);
    positions: (B, L) or (1, L). Returns (y, {"k", "v"}). (The non-causal
    and cross-attention forms wait for the vlm and audio families.)"""
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "flash":
        y = torch.einsum("blhd,hdk->blk", _flash(q, k, v).to(x.dtype), p.wo)
        return y, {"k": k, "v": v}
    scores = _gqa_scores(q, k)
    l, s = scores.shape[-2], scores.shape[-1]
    mask = torch.tril(torch.ones((l, s), dtype=torch.bool, device=x.device), diagonal=s - l)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    return _gqa_out(weights, v, p), {"k": k, "v": v}


def apply_attention_decode(p, cfg: ModelConfig, x, cache: dict, pos: int):
    """Single-token cached decode: writes the new K/V at ``pos`` of
    ``cache`` {"k", "v": (B, S, KV, hd)} in place (``repro`` returns an
    updated copy; the port keeps one cache buffer) and attends to positions
    [0, pos]. Returns (y, cache)."""
    q, k_new, v_new = _project_qkv(p, x)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, pos:pos + 1] = k_new.to(k.dtype)
    v[:, pos:pos + 1] = v_new.to(v.dtype)
    scores = _gqa_scores(q, k)  # (B, KV, G, 1, S)
    valid = torch.arange(k.shape[1], device=x.device) <= pos
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    return _gqa_out(weights, v, p), cache


def kv_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": TensorSpec(shp, dt), "v": TensorSpec(shp, dt)}
