"""Attention (``repro/models/attention.py``): GQA (with qwen2's QKV bias)
and MLA (DeepSeek-V3), each over a full sequence (train / prefill, naive or
flash) and as single-token cached decode; GQA also non-causal (whisper's
encoder) and as cross-attention to a frontend's embeddings (the vlm's
patches, whisper's encoded frames), whose decode attends to a fixed cache of
the frontend's keys and values.

Layouts and casts are ``repro``'s: activations (B, L, H, hd); scores in
float32; softmax weights cast to ``x.dtype`` before the value product; the
flash output cast to ``x.dtype`` before ``wo``. MLA's full-sequence form is
the expanded one (per-head K and V, the shared rope key broadcast over the
heads); its decode is the absorbed one, attending in the ``kv_lora`` latent,
so its cache holds only the latent and the rope key.

On a mesh step (``models.parallel``) the full-sequence forms are
tensor-parallel over the heads where the specs split them: ``wq`` / ``wk`` /
``wv`` (MLA: ``wq_b`` / ``wk_b`` / ``wv_b``) column-parallel, ``wo``
row-parallel with its partial outputs summed over the model axis, each rank
running attention (the flash kernels too) on its own heads. Where the query
heads split and the KV heads do not, the KV heads are computed whole and
each rank keeps those its query heads read.

Decode on a mesh (serving) reads the cache as ``cache_specs`` splits it,
the cache leaves' spec passed as ``spec``:

  * KV heads split over ``"model"``: each rank decodes its heads, as the
    full-sequence form computes them, and ``reduce_from`` sums the output
    projection's partial results;
  * the sequence dim (or a cross cache's frontend tokens) split: each rank
    scores its positions against every query head and returns its partial
    output with its log-sum-exp (``partial_softmax``); the ranks combine
    them exactly by all-reduces over ``"model"``, the largest LSE first,
    then the rescaled sums (``combine_partials``: the partial-softmax
    reduction XLA inserts in ``repro``). A rank whose positions all lie
    beyond ``pos`` contributes a zero output at an LSE of -inf.

Where the query heads split and the cache's KV heads do not, the query is
gathered whole, attention runs over every head, and each rank keeps its
heads' context for its block of ``wo``.
"""

from __future__ import annotations

from collections import namedtuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import parallel as par
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MODEL,
    P,
    RMSNorm,
    ShardCtx,
    apply_rope,
    dtype_of,
    ninit,
    param,
    rms_norm,
    rmsnorm_specs,
)

NEG_INF = -1e30

TensorSpec = namedtuple("TensorSpec", "shape dtype")


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA projections under ``repro``'s keys: wq (d, H, hd), wk / wv
    (d, KV, hd), wo (H, hd, d); with ``qkv_bias`` also bq (H, hd) and bk /
    bv (KV, hd), initialised to zeros."""

    tp_keys = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param((d, h, hd), dtype, device)
        self.wk = param((d, kv, hd), dtype, device)
        self.wv = param((d, kv, hd), dtype, device)
        self.wo = param((h, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = param((h, hd), dtype, device)
            self.bk = param((kv, hd), dtype, device)
            self.bv = param((kv, hd), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        s = d**-0.5
        for w, scale in ((self.wq, s), (self.wk, s), (self.wv, s), (self.wo, (h * hd) ** -0.5)):
            w.copy_(ninit(generator, w.shape, scale, w.dtype))
        if cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()


def attention_specs(ctx: ShardCtx, cfg: ModelConfig, cross: bool = False) -> dict:
    h_sh = ctx.heads(cfg.n_heads)
    kv_sh = ctx.heads(cfg.n_kv_heads)
    dd = ctx.data(cfg.d_model)
    p = {
        "wq": P(dd, h_sh, None),
        "wk": P(dd, kv_sh, None),
        "wv": P(dd, kv_sh, None),
        "wo": P(h_sh, None, dd),
    }
    if cfg.qkv_bias:
        p["bq"] = P(h_sh, None)
        p["bk"] = P(kv_sh, None)
        p["bv"] = P(kv_sh, None)
    return p


def _project_q(p, cfg: ModelConfig, x):
    q = torch.einsum("bld,dhk->blhk", x, p.wq)
    return q + p.bq if cfg.qkv_bias else q


def _project_qkv(p, cfg: ModelConfig, x, kv_src=None, tp=None):
    """q from ``x``; k and v from ``kv_src`` (cross-attention) or ``x``.
    With ``tp`` (the query heads split over the model axis) the split
    projections read their input through ``copy_to``; KV heads that are not
    split are projected whole from the replicated input."""
    kv_in = x if kv_src is None else kv_src
    if tp is not None:
        x = par.copy_to(x, tp)
        if par.tp_group(p, "wk") is not None:
            kv_in = x if kv_src is None else par.copy_to(kv_src, tp)
    k = torch.einsum("bld,dhk->blhk", kv_in, p.wk)
    v = torch.einsum("bld,dhk->blhk", kv_in, p.wv)
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return _project_q(p, cfg, x), k, v


def _local_kv(k, v, tp, n_heads: int, local_heads: int):
    """Whole KV heads (B, S, KV, hd) cut to those this rank's query heads
    read, through ``copy_to``: one per query head, query head h of [r Hl,
    (r + 1) Hl) reading KV head h // (H / KV)."""
    lo = tp.index * local_heads
    idx = torch.arange(lo, lo + local_heads, device=k.device) // (n_heads // k.shape[2])
    return (par.copy_to(k, tp).index_select(2, idx), par.copy_to(v, tp).index_select(2, idx))


def _gqa_scores(q, k):
    """q: (B, L, H, hd); k: (B, S, KV, hd) -> (B, KV, G, L, S) float32 (the
    product in the input dtype, then divided by a float32 sqrt(hd))."""
    b, l, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, l, kvh, g, hd)
    root = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=q.device))
    return torch.einsum("blkgd,bskd->bkgls", qg, k).float() / root


def _gqa_ctx(weights, v):
    """weights: (B, KV, G, L, S); v: (B, S, KV, hd) -> the context (B, L, H,
    hd)."""
    b, kvh, g, l, s = weights.shape
    ctx = torch.einsum("bkgls,bskd->blkgd", weights, v)
    return ctx.reshape(b, l, kvh * g, v.shape[-1])


def _gqa_out(weights, v, p):
    """weights: (B, KV, G, L, S); v: (B, S, KV, hd) -> (B, L, D)."""
    return torch.einsum("blhd,hdk->blk", _gqa_ctx(weights, v), p.wo)


def partial_softmax(scores, valid, dtype):
    """One rank's share of a softmax over positions split across ranks:
    ``scores`` (..., S) float32, ``valid`` broadcastable to it. Returns
    (the weights over this rank's positions, normalised among them and cast
    to ``dtype``; their log-sum-exp (..., 1) float32). With no valid
    position the weights are 0 and the LSE is -inf, with no NaN."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    m = masked.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    e = torch.exp(masked - m)
    l = e.sum(-1, keepdim=True)
    w = (e / torch.where(l > 0, l, torch.ones_like(l))).to(dtype)
    return w, torch.log(l) + m


def combine_partials(out, lse, ag):
    """The exact softmax output from each rank's partial ``out`` (..., d),
    normalised over its positions, and its LSE (..., 1): the largest LSE
    over the group first, then the sums of the outputs and of the weights
    rescaled to it (float32; ``out``'s dtype back)."""
    top = par.all_reduce(lse, ag, torch.distributed.ReduceOp.MAX)
    scale = torch.exp(lse - top)  # 0 for a rank with no valid position
    sums = par.all_reduce(torch.cat([out.float() * scale, scale], dim=-1), ag)
    return (sums[..., :-1] / sums[..., -1:]).to(out.dtype)


def _decode_heads(q, tp, kv_split: bool):
    """The query heads decode attends with: this rank's where the cache's
    KV heads are split with them (or nothing is split), else every head
    (gathered)."""
    return q if tp is None or kv_split else par.all_gather(q, tp, 2)


def _project_out(p, ctx, tp, kv_split: bool):
    """ctx (B, L, H or this rank's heads, hd) through ``wo``: with ``tp``,
    this rank's heads through its rows, the partial outputs summed."""
    if tp is None:
        return torch.einsum("blhd,hdk->blk", ctx, p.wo)
    if not kv_split:
        n = p.wo.shape[0]
        ctx = ctx.narrow(2, tp.index * n, n)
    return par.reduce_from(torch.einsum("blhd,hdk->blk", ctx, p.wo), tp)


def _flash(q, k, v, scale=None, causal=True):
    """The flash kernel on (B, L, H, d)-layout tensors (``repro``'s
    ``_flash_scaled``; ``scale`` defaults to q's head dim ** -0.5): the
    kernel reads the transposed views by stride, no copy."""
    out, _ = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
                             q.shape[-1] ** -0.5 if scale is None else scale)
    return out.transpose(1, 2)


def _causal(scores):
    """``repro``'s bottom-right causal mask, ``tril(k = S - L)``."""
    l, s = scores.shape[-2], scores.shape[-1]
    mask = torch.tril(torch.ones((l, s), dtype=torch.bool, device=scores.device), diagonal=s - l)
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def _up_to(scores, pos: int):
    """Decode's mask: cache positions [0, pos] only."""
    valid = torch.arange(scores.shape[-1], device=scores.device) <= pos
    return torch.where(valid, scores, torch.full_like(scores, NEG_INF))


def apply_attention(p, cfg: ModelConfig, x, positions, *, causal: bool = True, kv_src=None):
    """Full-sequence attention (train / prefill). x: (B, L, D); positions:
    (B, L) or (1, L); ``kv_src`` (B, T, D): cross-attention, keys and values
    projected from it, no RoPE and no mask. The mask applies where
    ``causal`` and not ``kv_src``. Returns (y, {"k", "v"} of the keys
    attended to)."""
    tp = par.tp_group(p, "wq")
    q, k, v = _project_qkv(p, cfg, x, kv_src, tp)
    if kv_src is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    cache = {"k": k, "v": v}
    if tp is not None and par.tp_group(p, "wk") is None:
        k, v = _local_kv(k, v, tp, cfg.n_heads, q.shape[2])
    masked = causal and kv_src is None
    if cfg.attn_impl == "flash":
        y = torch.einsum("blhd,hdk->blk", _flash(q, k, v, causal=masked).to(x.dtype), p.wo)
    else:
        scores = _gqa_scores(q, k)
        weights = torch.softmax(_causal(scores) if masked else scores, dim=-1).to(x.dtype)
        y = _gqa_out(weights, v, p)
    return (y if tp is None else par.reduce_from(y, tp)), cache


def _seq_group(spec, dim: int = 1):
    """The model axis's group where a cache leaf's ``spec`` splits dim
    ``dim`` (positions or frontend tokens) over more than one rank, else
    None (a split over a group of one is the whole dim: decode runs as on
    one device)."""
    ag = par.model_group() if spec is not None and spec[dim] == MODEL else None
    return ag if ag is not None and ag.size > 1 else None


def apply_attention_decode(p, cfg: ModelConfig, x, cache: dict, pos: int, spec=None):
    """Single-token cached decode: writes the new K/V at ``pos`` of
    ``cache`` {"k", "v": (B, S, KV, hd)} in place (``repro`` returns an
    updated copy; the port keeps one cache buffer) and attends to positions
    [0, pos]. On a mesh, ``spec`` is the cache leaves' (see the module
    docstring): with the sequence split, this rank holds positions [r S_l,
    (r + 1) S_l) and writes the new entry only where ``pos`` falls among
    them. Returns (y, cache)."""
    tp = par.tp_group(p, "wq")
    kv_split = par.tp_group(p, "wk") is not None
    seq = _seq_group(spec)
    q, k_new, v_new = _project_qkv(p, cfg, x, tp=tp)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = _decode_heads(apply_rope(q, posv, cfg.rope_theta), tp, kv_split)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    lo = 0 if seq is None else seq.index * k.shape[1]
    if 0 <= pos - lo < k.shape[1]:
        k[:, pos - lo:pos - lo + 1] = k_new.to(k.dtype)
        v[:, pos - lo:pos - lo + 1] = v_new.to(v.dtype)
    scores = _gqa_scores(q, k)  # (B, KV, G, 1, S)
    if seq is None:
        ctx = _gqa_ctx(torch.softmax(_up_to(scores, pos), dim=-1).to(x.dtype), v)
    else:
        valid = torch.arange(lo, lo + k.shape[1], device=x.device) <= pos
        w, lse = partial_softmax(scores, valid, x.dtype)
        ctx = combine_partials(_gqa_ctx(w, v), _gqa_lse(lse), seq)
    return _project_out(p, ctx, tp, kv_split), cache


def _gqa_lse(lse):
    """(B, KV, G, L, 1) -> (B, L, H, 1), the context's layout."""
    b, kvh, g, l, _ = lse.shape
    return lse.permute(0, 3, 1, 2, 4).reshape(b, l, kvh * g, 1)


def apply_cross_attention_decode(p, cfg: ModelConfig, x, ctx_cache: dict, spec=None):
    """Decode-time cross-attention: x (B, 1, D) attends, unmasked, to the
    whole fixed ``ctx_cache`` {"k", "v": (B, T, KV, hd)} that the prefill's
    cross-attention returned; the cache is read, never written. On a mesh
    ``spec`` splits its KV heads or its frontend tokens, as the self
    cache's heads or positions (every token valid)."""
    tp = par.tp_group(p, "wq")
    kv_split = par.tp_group(p, "wk") is not None
    seq = _seq_group(spec)
    if tp is not None:
        x = par.copy_to(x, tp)
    q = _decode_heads(_project_q(p, cfg, x), tp, kv_split)
    scores = _gqa_scores(q, ctx_cache["k"])
    if seq is None:
        ctx = _gqa_ctx(torch.softmax(scores, dim=-1).to(x.dtype), ctx_cache["v"])
    else:
        w, lse = partial_softmax(scores, torch.ones((), dtype=torch.bool, device=x.device),
                                 x.dtype)
        ctx = combine_partials(_gqa_ctx(w, ctx_cache["v"]), _gqa_lse(lse), seq)
    return _project_out(p, ctx, tp, kv_split)


def kv_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": TensorSpec(shp, dt), "v": TensorSpec(shp, dt)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """MLA projections under ``repro``'s keys: wq_a (d, q_lora), q_norm,
    wq_b (q_lora, H, hd + rh), wkv_a (d, kv_lora + rh), kv_norm, wk_b / wv_b
    (kv_lora, H, hd), wo (H, hd, d)."""

    tp_keys = ("wq_b", "wk_b", "wv_b", "wo")

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        ql, kl, rh = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
        self.wq_a = param((d, ql), dtype, device)
        self.q_norm = RMSNorm(ql, dtype, device)
        self.wq_b = param((ql, h, hd + rh), dtype, device)
        self.wkv_a = param((d, kl + rh), dtype, device)
        self.kv_norm = RMSNorm(kl, dtype, device)
        self.wk_b = param((kl, h, hd), dtype, device)
        self.wv_b = param((kl, h, hd), dtype, device)
        self.wo = param((h, hd, d), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
        for w, scale in ((self.wq_a, d**-0.5), (self.wq_b, ql**-0.5), (self.wkv_a, d**-0.5),
                         (self.wk_b, kl**-0.5), (self.wv_b, kl**-0.5),
                         (self.wo, (h * hd) ** -0.5)):
            w.copy_(ninit(generator, w.shape, scale, w.dtype))
        self.q_norm.scale.fill_(1.0)
        self.kv_norm.scale.fill_(1.0)


def mla_specs(ctx: ShardCtx, cfg: ModelConfig) -> dict:
    h_sh = ctx.heads(cfg.n_heads)
    dd = ctx.data(cfg.d_model)
    return {
        "wq_a": P(dd, None),
        "q_norm": rmsnorm_specs(),
        "wq_b": P(None, h_sh, None),
        "wkv_a": P(dd, None),
        "kv_norm": rmsnorm_specs(),
        "wk_b": P(None, h_sh, None),
        "wv_b": P(None, h_sh, None),
        "wo": P(h_sh, None, dd),
    }


def _mla_q(p, cfg: ModelConfig, x, positions, tp=None):
    """(q_nope (B, L, H, hd), q_rope (B, L, H, rh) rotated); with ``tp``
    this rank's heads."""
    cq = rms_norm(p.q_norm, torch.einsum("bld,dq->blq", x, p.wq_a))
    if tp is not None:
        cq = par.copy_to(cq, tp)
    q = torch.einsum("blq,qhk->blhk", cq, p.wq_b)
    q_nope, q_rope = q[..., :cfg.head_dim], q[..., cfg.head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(p, cfg: ModelConfig, x, positions):
    """(ckv (B, L, kv_lora) normed, k_rope (B, L, rh) rotated): the
    compressed cache entries."""
    kv = torch.einsum("bld,dk->blk", x, p.wkv_a)
    ckv = rms_norm(p.kv_norm, kv[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(kv[:, :, None, cfg.kv_lora_rank:], positions, cfg.rope_theta)
    return ckv, k_rope[:, :, 0, :]


def apply_mla(p, cfg: ModelConfig, x, positions):
    """Full-sequence MLA (train / prefill), expanded form. Returns (y, the
    compressed cache {"ckv", "krope"}). Under ``attn_impl="flash"`` the
    kernel takes q = [q_nope ; q_rope] and k = [k_nope ; k_rope] (dk = hd +
    rh, dv = hd) at scale (hd + rh) ** -0.5."""
    hd, rh = cfg.head_dim, cfg.rope_head_dim
    tp = par.tp_group(p, "wq_b")
    q_nope, q_rope = _mla_q(p, cfg, x, positions, tp)
    ckv, k_rope = _mla_latents(p, cfg, x, positions)
    cache = {"ckv": ckv, "krope": k_rope}
    if tp is not None:  # the latents enter this rank's heads
        ckv, k_rope = par.copy_to(ckv, tp), par.copy_to(k_rope, tp)
    k_nope = torch.einsum("blk,khd->blhd", ckv, p.wk_b)
    v = torch.einsum("blk,khd->blhd", ckv, p.wv_b)
    scale = (hd + rh) ** -0.5
    if cfg.attn_impl == "flash":
        q_full = torch.cat([q_nope, q_rope], dim=-1)  # (B, L, H, hd + rh)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], rh)], dim=-1)
        ctx = _flash(q_full, k_full, v, scale)
        y = torch.einsum("blhd,hdk->blk", ctx.to(x.dtype), p.wo)
    else:
        scores = (torch.einsum("blhd,bshd->bhls", q_nope, k_nope)
                  + torch.einsum("blhr,bsr->bhls", q_rope, k_rope)).float() * scale
        w = torch.softmax(_causal(scores), dim=-1).to(x.dtype)
        ctx = torch.einsum("bhls,bshd->blhd", w, v)
        y = torch.einsum("blhd,hdk->blk", ctx, p.wo)
    return (y if tp is None else par.reduce_from(y, tp)), cache


def apply_mla_decode(p, cfg: ModelConfig, x, cache: dict, pos: int, spec=None):
    """Compressed-cache MLA decode by projection absorption: W_uk folds into
    the query and W_uv into the output, so attention runs in the
    ``kv_lora`` latent and per-head K/V are never materialised. Writes the
    new latent and rope key at ``pos`` of ``cache`` {"ckv": (B, S, kv_lora),
    "krope": (B, S, rh)} in place. On a mesh ``spec`` ({"ckv", "krope"})
    splits the positions (each rank scores its block against every head;
    ``combine_partials``) or the latent's last dim (each rank's share of
    the latent scores summed over the model axis, the latent context
    gathered); the heads of ``wq_b`` / ``wk_b`` / ``wv_b`` / ``wo`` split as
    in the full-sequence form. Returns (y, cache)."""
    hd, rh = cfg.head_dim, cfg.rope_head_dim
    tp = par.tp_group(p, "wq_b")
    seq = _seq_group(None if spec is None else spec["ckv"])
    lat = _seq_group(None if spec is None else spec["ckv"], 2)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, posv, tp)  # (B, 1, H, hd / rh)
    ckv_new, krope_new = _mla_latents(p, cfg, x, posv)
    ckv, krope = cache["ckv"], cache["krope"]
    lo = 0 if seq is None else seq.index * ckv.shape[1]
    if 0 <= pos - lo < ckv.shape[1]:
        if lat is not None:
            ckv_new = ckv_new.narrow(2, lat.index * ckv.shape[2], ckv.shape[2])
        ckv[:, pos - lo:pos - lo + 1] = ckv_new.to(ckv.dtype)
        krope[:, pos - lo:pos - lo + 1] = krope_new.to(krope.dtype)
    q_eff = torch.einsum("blhd,khd->blhk", q_nope, p.wk_b)  # (B, 1, H, kv_lora)
    every = seq is not None or lat is not None
    if every:  # every head scores this rank's share of the cache
        q_eff, q_rope = _decode_heads(q_eff, tp, False), _decode_heads(q_rope, tp, False)
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd + rh), dtype=torch.float32, device=x.device))
    if lat is not None:
        q_eff = q_eff.narrow(3, lat.index * ckv.shape[2], ckv.shape[2])
        nope = par.all_reduce(torch.einsum("blhk,bsk->bhls", q_eff, ckv), lat)
        scores = (nope + torch.einsum("blhr,bsr->bhls", q_rope, krope)).float() * scale
    else:
        scores = (torch.einsum("blhk,bsk->bhls", q_eff, ckv)
                  + torch.einsum("blhr,bsr->bhls", q_rope, krope)).float() * scale
    if seq is None:
        w = torch.softmax(_up_to(scores, pos), dim=-1).to(x.dtype)
        ctx = torch.einsum("bhls,bsk->blhk", w, ckv)  # the latent context
        if lat is not None:
            ctx = par.all_gather(ctx, lat, 3)
    else:
        valid = torch.arange(lo, lo + ckv.shape[1], device=x.device) <= pos
        w, lse = partial_softmax(scores, valid, x.dtype)
        ctx = combine_partials(torch.einsum("bhls,bsk->blhk", w, ckv), lse.transpose(1, 2),
                               seq)
    if every and tp is not None:
        n = p.wv_b.shape[1]
        ctx = ctx.narrow(2, tp.index * n, n)
    v = torch.einsum("blhk,khd->blhd", ctx, p.wv_b)  # W_uv absorbed
    y = torch.einsum("blhd,hdk->blk", v, p.wo)
    return (y if tp is None else par.reduce_from(y, tp)), cache


def mla_cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    dt = dtype_of(cfg)
    return {"ckv": TensorSpec((batch, max_len, cfg.kv_lora_rank), dt),
            "krope": TensorSpec((batch, max_len, cfg.rope_head_dim), dt)}
