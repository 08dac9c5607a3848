"""Model assembly for the dense family (``repro/models/transformer.py``):
init, forward (with ``repro``'s remat policies), the training loss, prefill
and cached decode.

``repro`` scans over layer-stacked parameters; the port holds a
``ModuleList`` of blocks and loops over it, and ``jax.checkpoint`` over the
scan body becomes ``torch.utils.checkpoint`` around each block. The decode cache keeps
``repro``'s tree and layout, ``{"layers": {"k", "v": (n_layers, B, max_len,
KV, hd)}}``, as one buffer that prefill fills and each decode step updates
in place. The other families (moe, ssm, hybrid, vlm, audio) raise
``NotImplementedError`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Embed,
    RMSNorm,
    apply_mlp,
    dtype_of,
    embed_tokens,
    rms_norm,
    unembed,
)


AUX_LOSS_COEF = 0.01


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.use_mla or cfg.qkv_bias:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family without MLA or qkv bias is ported "
            "(ROADMAP Queue 1 item 10)")


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


class Transformer(nn.Module):
    """The dense model's parameters under ``repro``'s tree keys: ``embed``,
    ``final_norm`` and ``layers`` (one ``DenseBlock`` per layer where
    ``repro`` stacks the leaves on axis 0)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _dense_only(cfg)
        dtype = dtype_of(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, dtype, device) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Transformer:
    """Random parameters at ``repro``'s scales (``ninit``), drawn from
    ``generator``, on ``device`` (``None`` -> CUDA; raises when CUDA is
    absent). The draws differ from ``jax.random``'s: parity with ``repro``
    comes from carrying parameters across (``convert.model_params_*``)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lies on {generator.device}, parameters on {dev}")
    model = Transformer(cfg, dev)
    model.embed.init(generator, cfg)
    for norm in [model.final_norm] + [m for blk in model.layers for m in (blk.ln1, blk.ln2)]:
        norm.scale.fill_(1.0)
    for blk in model.layers:
        blk.attn.init(generator, cfg)
        blk.mlp.init(generator)
    return model


def _block_seq(p: DenseBlock, cfg: ModelConfig, h, positions):
    """One dense block over a full sequence. Returns (h, cache_kv)."""
    y, cache = attn.apply_attention(p.attn, cfg, rms_norm(p.ln1, h), positions)
    h = h + y
    return h + apply_mlp(p.mlp, rms_norm(p.ln2, h)), cache


def _block_decode(p: DenseBlock, cfg: ModelConfig, h, cache: dict, pos: int):
    y, cache = attn.apply_attention_decode(p.attn, cfg, rms_norm(p.ln1, h), cache, pos)
    h = h + y
    return h + apply_mlp(p.mlp, rms_norm(p.ln2, h)), cache


def _positions(l: int, device) -> torch.Tensor:
    return torch.arange(l, dtype=torch.int32, device=device)[None]


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of products
    with no batch dimension (the weight matmuls: ``x @ w`` runs as ``mm``, a
    projection einsum as a ``bmm`` over one batch), recompute everything
    else (attention's batched score and value products among them)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``repro``'s ``_remat`` over one block: ``none`` keeps every
    activation, ``full`` keeps only the block's input and recomputes the
    block in the backward, ``dots`` keeps the weight matmuls' outputs too.
    Without autograd (prefill, decode) the block just runs."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if cfg.remat == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat == "dots":
            return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_weight_matmuls))
        return ckpt.checkpoint(fn, *args, use_reentrant=False)

    return run


def make_forward(cfg: ModelConfig):
    """Returns fn(params, tokens) -> (logits (B, L, V), aux_loss, None), as
    ``repro``'s dense forward (the third slot is the MTP head's logits).
    Each block runs under ``cfg.remat`` when autograd records."""
    _dense_only(cfg)

    def fwd(params: Transformer, tokens: torch.Tensor):
        positions = _positions(tokens.shape[1], tokens.device)
        h = embed_tokens(params.embed, tokens)
        for blk in params.layers:
            h = _remat(lambda x, blk=blk: _block_seq(blk, cfg, x, positions)[0], cfg)(h)
        h = rms_norm(params.final_norm, h)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return unembed(params.embed, h, cfg), aux, None

    return fwd


def _cross_entropy(logits, labels, mask):
    """Mean next-token NLL over ``mask``, with an fp32 logsumexp."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(cfg: ModelConfig):
    """Returns fn(params, batch) -> scalar float32 loss, as ``repro``'s
    ``make_loss_fn``: labels are the tokens rolled by -1, the last position
    is masked, and the aux loss is added at ``AUX_LOSS_COEF``. (The MTP term
    comes with the moe family.)"""
    fwd = make_forward(cfg)

    def loss_fn(params: Transformer, batch: dict) -> torch.Tensor:
        if batch.get("frontend") is not None:
            raise NotImplementedError("frontend embeddings come with the vlm and audio "
                                      "families (ROADMAP Queue 1 item 10)")
        tokens = batch["tokens"]
        logits, aux, logits_mtp = fwd(params, tokens)
        if logits_mtp is not None:
            raise NotImplementedError("the MTP loss comes with the moe family "
                                      "(ROADMAP Queue 1 item 10)")
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
        mask[:, -1] = 0.0
        return _cross_entropy(logits, labels, mask) + AUX_LOSS_COEF * aux

    return loss_fn


def cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shape/dtype tree of the decode cache."""
    _dense_only(cfg)
    a = attn.kv_cache_shape(cfg, batch, max_len)
    return {"layers": {k: attn.TensorSpec((cfg.n_layers,) + s.shape, s.dtype)
                       for k, s in a.items()}}


def make_prefill(cfg: ModelConfig, max_len: int):
    """Returns fn(params, tokens) -> (last_logits (B, V), cache): the cache
    holds K/V for positions [0, L) and zeros up to ``max_len``, as
    ``_pad_cache_len`` pads. Runs under ``torch.inference_mode``."""
    _dense_only(cfg)

    @torch.inference_mode()
    def prefill(params: Transformer, tokens: torch.Tensor):
        b, l = tokens.shape
        if l > max_len:
            raise ValueError(f"prompt length {l} exceeds max_len {max_len}")
        spec = cache_shape(cfg, b, max_len)["layers"]
        cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=tokens.device)
                 for k, s in spec.items()}
        positions = _positions(l, tokens.device)
        h = embed_tokens(params.embed, tokens)
        for i, blk in enumerate(params.layers):
            h, c = _block_seq(blk, cfg, h, positions)
            cache["k"][i, :, :l] = c["k"]
            cache["v"][i, :, :l] = c["v"]
        h = rms_norm(params.final_norm, h[:, -1:])
        return unembed(params.embed, h, cfg)[:, 0], {"layers": cache}

    return prefill


def make_decode_step(cfg: ModelConfig):
    """Returns fn(params, token (B,), cache, pos) -> (logits (B, V), cache).
    The cache is updated in place (one 2.4 GB buffer at llama3.2-1b's width,
    batch 64 and 1152 positions; ``repro`` returns a functional copy) and
    returned. Runs under ``torch.inference_mode``."""
    _dense_only(cfg)

    @torch.inference_mode()
    def decode(params: Transformer, token: torch.Tensor, cache: dict, pos: int):
        h = embed_tokens(params.embed, token[:, None])
        layers = cache["layers"]
        for i, blk in enumerate(params.layers):
            h, _ = _block_decode(blk, cfg, h, {"k": layers["k"][i], "v": layers["v"][i]},
                                 int(pos))
        h = rms_norm(params.final_norm, h)
        return unembed(params.embed, h, cfg)[:, 0], cache

    return decode
