"""Model assembly for the dense, moe, ssm, hybrid, vlm and audio families
(``repro/models/transformer.py``): init, forward (with ``repro``'s remat
policies and the moe family's MTP head), the training loss, prefill and
cached decode.

``repro`` scans over layer-stacked parameters; the port holds ``ModuleList``s
of blocks and loops over them, and ``jax.checkpoint`` over the scan body
becomes ``torch.utils.checkpoint`` around each block. A moe model runs its
``dense_layers`` (``first_dense_layers`` dense blocks) before its MoE
``layers``; attention is MLA where ``use_mla``, else GQA. The decode cache
keeps ``repro``'s tree and layout, ``{"layers": ..., "dense_layers": ...}``
of ``{"k", "v": (n, B, max_len, KV, hd)}`` or, under MLA, ``{"ckv":
(n, B, max_len, kv_lora), "krope": (n, B, max_len, rh)}``, as one buffer
per leaf that prefill fills and each decode step updates in place.

The ssm family (rwkv6-7b) is a stack of ``RWKV6Block``s; the hybrid family
(zamba2-1.2b) groups its Mamba2 ``layers`` by ``attn_every``, each group
followed by the one weight-shared ``shared_attn`` (a ``DenseBlock``), the
``n_layers % attn_every`` remainder layers after the last group. Their
decode "cache" is the recurrent state, whose size does not depend on
``max_len``: ``{"layers": {"tm_x", "cm_x", "wkv"}}`` stacked over the rwkv6
blocks, or ``{"mamba": {"conv", "ssm"}}`` stacked over the Mamba2 blocks
beside ``{"shared": {"k", "v"}}``, the shared block's KV per group
application (n_groups, B, max_len, KV, hd). Prefill writes the state after
the prompt; each decode step overwrites it in place.

The vlm family (llama-3.2-vision-90b) runs ``n_layers // cross_attn_every``
``groups``, each ``cross_attn_every - 1`` self-attention ``DenseBlock``s
(``self``) and then ``cross``, a ``DenseBlock`` whose attention reads the
frontend's patch embeddings, unnormalised, as keys and values. The audio
family (whisper-large-v3) runs its ``encoder`` (``encoder_layers``
``DenseBlock``s, non-causal, with RoPE) over the frame embeddings, then
``enc_norm``; each decoder ``layer`` is a ``DenseBlock`` followed by
``ln_x`` and ``cross``, attention over the encoded frames (no MLP after
it). Both take the frontend ``(B, n_frontend_tokens, d_model)`` in the
forward, the loss (``batch["frontend"]``) and prefill, cast to the model's
dtype (``repro`` promotes a bf16 frontend to an fp32 model's dtype, which is
the same values). Their cache is ``{"self": {"k", "v"}, "cross": {"k",
"v"}}``: the self-attention KV per layer ((n_groups, n_self, B, max_len,
KV, hd) for the vlm, (n_layers, B, max_len, KV, hd) for audio) and the
cross-attention's keys and values of the frontend per cross layer
((n, B, n_frontend_tokens, KV, hd)), written once by prefill and only read
by decode.

``param_specs`` gives each parameter's spec (``models.layers``), keyed by
the port's parameter names (``layers.3.attn.wq``): ``repro``'s spec without
the leading layer dims that its stacking adds. ``cache_specs`` gives the
decode cache's, in ``repro``'s tree. On a mesh step (``models.parallel``)
the forward and the loss run tensor-parallel where the specs split the
model axis, the logits vocab-split, the cross-entropy reducing its max, sum
of exponentials and gold logit over the model axis.

Prefill and decode run on a mesh too (``serving.engine.ServingEngine(mesh=)``
drives them): each rank takes its rows of the batch and holds its block of
every cache leaf, as the cache specs the caller gave ``par.on_mesh``
(``models.parallel.cache_specs()``; ``mesh_cache_specs``) split it. Prefill
allocates only the rank's blocks and writes each block from the entries it
computed (a KV cache split by heads from the rank's own heads, one split by
positions or frontend tokens from its share of the whole entries); decode
reads and updates them in place (``models.attention``, ``rwkv6``,
``mamba2``). The logits come back whole over the vocabulary
(``par.gather_vocab``), for the rank's rows.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel as par
from repro_torch.models import rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    DATA,
    MLP,
    MODEL,
    POD,
    Embed,
    P,
    RMSNorm,
    ShardCtx,
    apply_mlp,
    dtype_of,
    embed_specs,
    embed_tokens,
    mlp_specs,
    ninit,
    param,
    rms_norm,
    rmsnorm_specs,
    unembed,
)


AUX_LOSS_COEF = 0.01
MTP_LOSS_COEF = 0.3


def _attention(cfg: ModelConfig, dtype, device) -> nn.Module:
    return attn.MLA(cfg, dtype, device) if cfg.use_mla else attn.Attention(cfg, dtype, device)


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = _attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


class MoEBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = _attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, dtype, device)
        self.moe = moe_mod.MoE(cfg, dtype, device)


class CrossGroup(nn.Module):
    """One vlm group: ``self``, ``cross_attn_every - 1`` self-attention
    blocks, then ``cross``, a full dense block whose attention reads the
    frontend."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.self = nn.ModuleList(DenseBlock(cfg, dtype, device)
                                  for _ in range(cfg.cross_attn_every - 1))
        self.cross = DenseBlock(cfg, dtype, device)


class DecoderLayer(DenseBlock):
    """One audio decoder layer: a dense block, then ``ln_x`` and ``cross``,
    attention over the encoded frames (the same leaves as self-attention)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        self.ln_x = RMSNorm(cfg.d_model, dtype, device)
        self.cross = attn.Attention(cfg, dtype, device)


class MTPHead(nn.Module):
    """The multi-token-prediction head: ``proj`` (2d, d) over [h_t ;
    emb(t_{t+1})], one dense block, a norm."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.proj = param((2 * cfg.d_model, cfg.d_model), dtype, device)
        self.block = DenseBlock(cfg, dtype, device)
        self.norm = RMSNorm(cfg.d_model, dtype, device)


class Transformer(nn.Module):
    """Parameters under ``repro``'s tree keys: ``embed``, ``final_norm``,
    ``layers`` (one block per layer where ``repro`` stacks the leaves on
    axis 0), for the moe family ``dense_layers`` and ``mtp``, for the hybrid
    family ``shared_attn`` (unstacked); the vlm family has ``groups`` (no
    ``layers``), the audio family ``encoder`` and ``enc_norm`` beside its
    decoder ``layers``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = dtype_of(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        if cfg.family == "vlm":
            self.groups = nn.ModuleList(CrossGroup(cfg, dtype, device)
                                        for _ in range(cfg.n_layers // cfg.cross_attn_every))
            return
        if cfg.family == "audio":
            self.encoder = nn.ModuleList(DenseBlock(cfg, dtype, device)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, dtype, device)
            self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
            return
        block = {"dense": DenseBlock, "ssm": rwkv6.RWKV6Block,
                 "hybrid": mamba2.Mamba2Block}.get(cfg.family)
        if block is not None:
            self.layers = nn.ModuleList(block(cfg, dtype, device) for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                self.shared_attn = DenseBlock(cfg, dtype, device)
            return
        nd = cfg.first_dense_layers
        if nd:
            self.dense_layers = nn.ModuleList(DenseBlock(cfg, dtype, device) for _ in range(nd))
        self.layers = nn.ModuleList(MoEBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers - nd))
        if cfg.mtp:
            self.mtp = MTPHead(cfg, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def stacks(self):
        """(tree key, blocks): every block, in the order the dense and moe
        forwards run them (where the key is also the cache's); the hybrid
        family's shared block comes last; the vlm's blocks group by group,
        the audio encoder's before its decoder layers."""
        if hasattr(self, "groups"):
            yield "groups", [blk for grp in self.groups for blk in (*grp.self, grp.cross)]
            return
        if hasattr(self, "encoder"):
            yield "encoder", self.encoder
        if hasattr(self, "dense_layers"):
            yield "dense_layers", self.dense_layers
        yield "layers", self.layers
        if hasattr(self, "shared_attn"):
            yield "shared_attn", (self.shared_attn,)


def _init_block(blk, generator: torch.Generator, cfg: ModelConfig) -> None:
    if isinstance(blk, (rwkv6.RWKV6Block, mamba2.Mamba2Block)):
        blk.init(generator, cfg)
        return
    blk.ln1.scale.fill_(1.0)
    blk.ln2.scale.fill_(1.0)
    blk.attn.init(generator, cfg)
    if isinstance(blk, MoEBlock):
        blk.moe.init(generator, cfg)
    else:
        blk.mlp.init(generator)
    if isinstance(blk, DecoderLayer):
        blk.ln_x.scale.fill_(1.0)
        blk.cross.init(generator, cfg)


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
    model.final_norm.scale.fill_(1.0)
    if hasattr(model, "enc_norm"):
        model.enc_norm.scale.fill_(1.0)
    for _, blocks in model.stacks():
        for blk in blocks:
            _init_block(blk, generator, cfg)
    if hasattr(model, "mtp"):
        d2 = 2 * cfg.d_model
        model.mtp.proj.copy_(ninit(generator, model.mtp.proj.shape, d2**-0.5,
                                   model.mtp.proj.dtype))
        _init_block(model.mtp.block, generator, cfg)
        model.mtp.norm.scale.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def _dense_block_specs(ctx: ShardCtx, cfg: ModelConfig) -> dict:
    return {
        "ln1": rmsnorm_specs(),
        "attn": attn.mla_specs(ctx, cfg) if cfg.use_mla else attn.attention_specs(ctx, cfg),
        "ln2": rmsnorm_specs(),
        "mlp": mlp_specs(ctx, cfg.d_model, cfg.d_ff),
    }


def _moe_block_specs(ctx: ShardCtx, cfg: ModelConfig) -> dict:
    return {
        "ln1": rmsnorm_specs(),
        "attn": attn.mla_specs(ctx, cfg) if cfg.use_mla else attn.attention_specs(ctx, cfg),
        "ln2": rmsnorm_specs(),
        "moe": moe_mod.moe_specs(ctx, cfg),
    }


def _named_specs(tree: dict, prefix: str, out: dict) -> dict:
    for key, sub in tree.items():
        if isinstance(sub, dict):
            _named_specs(sub, f"{prefix}{key}.", out)
        else:
            out[prefix + key] = sub
    return out


def param_specs(cfg: ModelConfig, ctx: ShardCtx = None) -> dict:
    """{parameter name: spec} of the ``Transformer`` of ``cfg`` under ``ctx``
    (default ``ShardCtx(fsdp=cfg.fsdp)``), ``repro``'s ``param_specs`` leaf
    for leaf without the stacked layer dims."""
    ctx = ctx or ShardCtx(fsdp=cfg.fsdp)
    out = _named_specs({"embed": embed_specs(ctx, cfg), "final_norm": rmsnorm_specs()}, "", {})

    def stack(name: str, n: int, block: dict) -> None:
        for i in range(n):
            _named_specs(block, f"{name}.{i}.", out)

    dense = _dense_block_specs(ctx, cfg)
    if cfg.family == "dense":
        stack("layers", cfg.n_layers, dense)
    elif cfg.family == "moe":
        stack("dense_layers", cfg.first_dense_layers, dense)
        stack("layers", cfg.n_layers - cfg.first_dense_layers, _moe_block_specs(ctx, cfg))
        if cfg.mtp:
            _named_specs({"proj": P(None, None), "block": dense, "norm": rmsnorm_specs()},
                         "mtp.", out)
    elif cfg.family == "ssm":
        stack("layers", cfg.n_layers, rwkv6.rwkv6_block_specs(ctx, cfg))
    elif cfg.family == "hybrid":
        stack("layers", cfg.n_layers, mamba2.mamba2_block_specs(ctx, cfg))
        _named_specs(dense, "shared_attn.", out)
    elif cfg.family == "vlm":
        for g in range(cfg.n_layers // cfg.cross_attn_every):
            stack(f"groups.{g}.self", cfg.cross_attn_every - 1, dense)
            _named_specs(dense, f"groups.{g}.cross.", out)
    elif cfg.family == "audio":
        stack("encoder", cfg.encoder_layers, dense)
        _named_specs({"enc_norm": rmsnorm_specs()}, "", out)
        stack("layers", cfg.n_layers, {**dense, "ln_x": rmsnorm_specs(),
                                       "cross": attn.attention_specs(ctx, cfg)})
    else:
        raise ValueError(cfg.family)
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, *, dp_size: int = 32,
                model_size: int = 16, multi_pod: bool = True) -> dict:
    """``repro``'s mesh-aware spec tree of ``cache_shape`` (quirks kept: the
    vlm's and audio's cross-cache branches). The batch splits over the
    data-parallel axes when divisible; KV heads over the model axis when
    divisible, else the cache's sequence dim (a sequence-sharded KV cache);
    SSM states their head dim."""
    dp = (POD, DATA) if multi_pod else (DATA,)
    dp_spec = dp if len(dp) > 1 else dp[0]
    b_sh = dp_spec if batch % dp_size == 0 and batch >= dp_size else None
    kv_ok = cfg.n_kv_heads % model_size == 0 and cfg.n_kv_heads >= model_size
    seq_ok = max_len % model_size == 0

    def kv_spec(extra_lead: int):
        # (B, S, KV, hd) with extra_lead stacked layer dims in front
        lead = (None,) * extra_lead
        if kv_ok:
            return P(*lead, b_sh, None, MODEL, None)
        if seq_ok:
            return P(*lead, b_sh, MODEL, None, None)
        return P(*lead, b_sh, None, None, None)

    def seq2_spec(extra_lead: int, last_div: int):
        # (B, S, X) latent caches (mla): shard S over model when divisible
        lead = (None,) * extra_lead
        if seq_ok:
            return P(*lead, b_sh, MODEL, None)
        if last_div % model_size == 0:
            return P(*lead, b_sh, None, MODEL)
        return P(*lead, b_sh, None, None)

    def map_attn(extra_lead: int):
        if cfg.use_mla:
            return {
                "ckv": seq2_spec(extra_lead, cfg.kv_lora_rank),
                "krope": P(*((None,) * extra_lead), b_sh, MODEL if seq_ok else None, None),
            }
        return {"k": kv_spec(extra_lead), "v": kv_spec(extra_lead)}

    d = cfg.d_model
    d_sh = MODEL if d % model_size == 0 else None
    if cfg.family == "dense":
        return {"layers": map_attn(1)}
    if cfg.family == "moe":
        out = {"layers": map_attn(1)}
        if cfg.first_dense_layers:
            out["dense_layers"] = map_attn(1)
        return out
    if cfg.family == "ssm":
        h = d // cfg.ssm_head_dim
        h_sh = MODEL if h % model_size == 0 else None
        return {"layers": {"tm_x": P(None, b_sh, d_sh), "cm_x": P(None, b_sh, d_sh),
                           "wkv": P(None, b_sh, h_sh, None, None)}}
    if cfg.family == "hybrid":
        d_inner = 2 * d
        h = d_inner // cfg.ssm_head_dim
        h_sh = MODEL if h % model_size == 0 else None
        conv_ch = d_inner + 2 * cfg.ssm_state
        return {
            "mamba": {
                "conv": P(None, b_sh, None, MODEL if conv_ch % model_size == 0 else None),
                "ssm": P(None, b_sh, h_sh, None, None),
            },
            "shared": map_attn(1),
        }
    t = cfg.n_frontend_tokens
    if cfg.family == "vlm":
        kv = (P(None, b_sh, None, MODEL, None) if kv_ok
              else P(None, b_sh, MODEL if t % model_size == 0 else None, None, None))
        return {"self": map_attn(2), "cross": {"k": kv, "v": kv}}
    if cfg.family == "audio":
        cross_seq = MODEL if t % model_size == 0 and not kv_ok else None
        kv = P(None, b_sh, None, MODEL, None) if kv_ok else P(None, b_sh, cross_seq, None, None)
        return {"self": map_attn(1), "cross": {"k": kv, "v": kv}}
    raise ValueError(cfg.family)


def _moe_fn(cfg: ModelConfig):
    return moe_mod.apply_moe_ep if cfg.moe_impl == "ep_manual" else moe_mod.apply_moe


def _block_seq(p, cfg: ModelConfig, h, positions, causal: bool = True):
    """One dense or MoE block over a full sequence (``causal=False``:
    whisper's encoder; MLA is always causal). Returns (h, aux or None for a
    dense block, the attention's cache entries)."""
    if cfg.use_mla:
        y, cache = attn.apply_mla(p.attn, cfg, rms_norm(p.ln1, h), positions)
    else:
        y, cache = attn.apply_attention(p.attn, cfg, rms_norm(p.ln1, h), positions,
                                        causal=causal)
    h = h + y
    hn = rms_norm(p.ln2, h)
    if isinstance(p, MoEBlock):
        y2, aux = _moe_fn(cfg)(p.moe, cfg, hn)
    else:
        y2, aux = apply_mlp(p.mlp, hn), None
    return h + y2, aux, cache


def _block_decode(p, cfg: ModelConfig, h, cache: dict, pos: int, spec=None):
    """One dense or MoE block's decode step; ``spec``: its cache slot's
    leaves' specs on a mesh."""
    hn = rms_norm(p.ln1, h)
    if cfg.use_mla:
        y, _ = attn.apply_mla_decode(p.attn, cfg, hn, cache, pos, spec)
    else:
        y, _ = attn.apply_attention_decode(p.attn, cfg, hn, cache, pos,
                                           None if spec is None else spec["k"])
    h = h + y
    hn = rms_norm(p.ln2, h)
    if isinstance(p, MoEBlock):
        return h + _moe_fn(cfg)(p.moe, cfg, hn)[0]
    return h + apply_mlp(p.mlp, hn)


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


def _zero_state(spec: dict, device) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device) for k, s in spec.items()}


def _hybrid_groups(cfg: ModelConfig):
    """[(Mamba2 layer indices, the shared block's application index or
    None)]: ``n_layers // attn_every`` groups of ``attn_every`` layers, each
    followed by the shared block, then the remainder layers alone (zamba2:
    38 = 6 x 6 + 2), as ``repro``'s ``_hybrid_forward`` runs them."""
    ae = cfg.attn_every
    n_groups = cfg.n_layers // ae
    out = [(range(g * ae, (g + 1) * ae), g) for g in range(n_groups)]
    if cfg.n_layers % ae:
        out.append((range(n_groups * ae, cfg.n_layers), None))
    return out


def _hybrid_group(params, cfg: ModelConfig, idx, shared: bool, h, positions):
    """The forward over one group: its Mamba2 layers from a zero state, then
    (``shared``) the shared block. ``repro`` remats a whole group, and runs
    the remainder layers outside the remat."""
    for i in idx:
        zero = _zero_state(mamba2.mamba2_state_shape(cfg, h.shape[0]), h.device)
        h = mamba2.apply_mamba2_block(params.layers[i], cfg, h, zero)[0]
    return _block_seq(params.shared_attn, cfg, h, positions)[0] if shared else h


def _frontend(cfg: ModelConfig, frontend):
    """The vlm's patch or the audio family's frame embeddings, in the model's
    dtype."""
    if frontend is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs frontend embeddings "
                         f"(B, {cfg.n_frontend_tokens}, {cfg.d_model})")
    return frontend.to(dtype_of(cfg))


def _cross_block(p, cfg: ModelConfig, h, positions, frontend):
    """The vlm's cross block: h + attention(ln1(h)) over the frontend, then
    h + mlp(ln2(h)). Returns (h, the cross-attention's {"k", "v"})."""
    y, cache = attn.apply_attention(p.attn, cfg, rms_norm(p.ln1, h), positions, causal=False,
                                    kv_src=frontend)
    h = h + y
    return h + apply_mlp(p.mlp, rms_norm(p.ln2, h)), cache


def _decoder_layer(p, cfg: ModelConfig, h, positions, enc):
    """One audio decoder layer: the causal block, then h + attention(ln_x(h))
    over the encoded frames. Returns (h, the self-attention's and the
    cross-attention's {"k", "v"})."""
    h, _, self_cache = _block_seq(p, cfg, h, positions)
    y, cross_cache = attn.apply_attention(p.cross, cfg, rms_norm(p.ln_x, h), positions,
                                          causal=False, kv_src=enc)
    return h + y, self_cache, cross_cache


def _encode_audio(params, cfg: ModelConfig, frames):
    """Whisper's encoder over the frame embeddings: non-causal blocks with
    RoPE, each under ``cfg.remat``, then ``enc_norm``."""
    positions = _positions(frames.shape[1], frames.device)
    h = frames
    for blk in params.encoder:
        h = _remat(lambda x, blk=blk: _block_seq(blk, cfg, x, positions, causal=False)[0], cfg)(h)
    return rms_norm(params.enc_norm, h)


def make_forward(cfg: ModelConfig):
    """Returns fn(params, tokens, frontend=None) -> (logits (B, L, V),
    aux_loss, logits_mtp (B, L, V) or None), as ``repro``'s forward: aux is
    the MoE blocks' aux losses summed; the MTP head runs here only (prefill
    and decode skip it); ``frontend`` (B, T, D) for the vlm and audio
    families. Each block runs under ``cfg.remat`` when autograd records (an
    audio decoder layer with its cross-attention as one unit, as ``repro``
    remats it)."""

    def fwd(params: Transformer, tokens: torch.Tensor, frontend=None):
        positions = _positions(tokens.shape[1], tokens.device)
        h = embed_tokens(params.embed, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.family == "vlm":
            src = _frontend(cfg, frontend)
            for grp in params.groups:
                for blk in grp.self:
                    h = _remat(lambda x, blk=blk: _block_seq(blk, cfg, x, positions)[0], cfg)(h)
                h = _remat(lambda x, f, p=grp.cross: _cross_block(p, cfg, x, positions, f)[0],
                           cfg)(h, src)
        elif cfg.family == "audio":
            enc = _encode_audio(params, cfg, _frontend(cfg, frontend))
            for lyr in params.layers:
                h = _remat(lambda x, e, p=lyr: _decoder_layer(p, cfg, x, positions, e)[0],
                           cfg)(h, enc)
        elif cfg.family == "ssm":
            for blk in params.layers:
                h = _remat(lambda x, blk=blk: rwkv6.apply_rwkv6_block(
                    blk, cfg, x, _zero_state(rwkv6.rwkv6_state_shape(cfg, x.shape[0]),
                                             x.device))[0], cfg)(h)
        elif cfg.family == "hybrid":
            for idx, g in _hybrid_groups(cfg):
                run = functools.partial(_hybrid_group, params, cfg, idx, g is not None,
                                        positions=positions)
                h = _remat(run, cfg)(h) if g is not None else run(h)
        else:
            for _, blocks in params.stacks():
                for blk in blocks:
                    h, a = _remat(lambda x, blk=blk: _block_seq(blk, cfg, x, positions)[:2],
                                  cfg)(h)
                    if a is not None:
                        aux = aux + a
        h = rms_norm(params.final_norm, h)
        logits = unembed(params.embed, h, cfg)
        if not (cfg.family == "moe" and cfg.mtp):
            return logits, aux, None
        # multi-token prediction: one extra block over [h_t ; emb(t_{t+1})]
        emb_next = torch.roll(embed_tokens(params.embed, tokens), -1, dims=1)
        mtp_in = torch.einsum("blf,fd->bld", torch.cat([h.to(dtype_of(cfg)), emb_next], dim=-1),
                              params.mtp.proj)
        h2 = rms_norm(params.mtp.norm, _block_seq(params.mtp.block, cfg, mtp_in, positions)[0])
        return logits, aux, unembed(params.embed, h2, cfg)

    return fwd


def _cross_entropy(logits, labels, mask, tp=None):
    """Mean next-token NLL over ``mask``, with an fp32 logsumexp; with ``tp``
    over logits split by vocab over the model axis."""
    lf = logits.float()
    if tp is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    else:
        lse, gold = par.vocab_lse_gold(lf, labels, tp)
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(cfg: ModelConfig):
    """Returns fn(params, batch) -> scalar float32 loss, as ``repro``'s
    ``make_loss_fn``: labels are the tokens rolled by -1, the last position
    is masked, and the aux loss is added at ``AUX_LOSS_COEF``; with the MTP
    head, ``MTP_LOSS_COEF`` times its loss on the tokens rolled by -2, the
    last two positions masked. ``batch["frontend"]`` feeds the vlm and
    audio families."""
    fwd = make_forward(cfg)

    def loss_fn(params: Transformer, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        logits, aux, logits_mtp = fwd(params, tokens, batch.get("frontend"))
        tp = par.tp_group(params.embed, "tok")
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
        mask[:, -1] = 0.0
        loss = _cross_entropy(logits, labels, mask, tp) + AUX_LOSS_COEF * aux
        if logits_mtp is not None:
            mask2 = mask.clone()
            mask2[:, -2] = 0.0
            loss = loss + MTP_LOSS_COEF * _cross_entropy(
                logits_mtp, torch.roll(tokens, -2, dims=1), mask2, tp)
        return loss

    return loss_fn


def cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shape/dtype tree of the decode cache: ``{"layers"}`` (dense) or
    ``{"layers", "dense_layers"}`` (moe with leading dense layers), each a
    stack over its blocks of ``{"k", "v"}`` or, under MLA, ``{"ckv",
    "krope"}``; ``{"layers": {"tm_x", "cm_x", "wkv"}}`` (ssm) or
    ``{"mamba": {"conv", "ssm"}, "shared": {"k", "v"}}`` (hybrid); ``{"self":
    {"k", "v"}, "cross": {"k", "v"}}`` (vlm: self stacked over groups and
    their self blocks; audio: both over the decoder layers), the cross
    leaves (n, B, n_frontend_tokens, KV, hd)."""
    a = (attn.mla_cache_shape if cfg.use_mla else attn.kv_cache_shape)(cfg, batch, max_len)
    stack = lambda n, tree=a: {k: attn.TensorSpec((n,) + s.shape, s.dtype)
                               for k, s in tree.items()}
    if cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_attn_every
        return {"self": stack(n_groups, stack(cfg.cross_attn_every - 1)),
                "cross": stack(n_groups, attn.kv_cache_shape(cfg, batch, cfg.n_frontend_tokens))}
    if cfg.family == "audio":
        return {"self": stack(cfg.n_layers),
                "cross": stack(cfg.n_layers,
                               attn.kv_cache_shape(cfg, batch, cfg.n_frontend_tokens))}
    if cfg.family == "dense":
        return {"layers": stack(cfg.n_layers)}
    if cfg.family == "ssm":
        return {"layers": stack(cfg.n_layers, rwkv6.rwkv6_state_shape(cfg, batch))}
    if cfg.family == "hybrid":
        return {"mamba": stack(cfg.n_layers, mamba2.mamba2_state_shape(cfg, batch)),
                "shared": stack(cfg.n_layers // cfg.attn_every)}
    out = {"layers": stack(cfg.n_layers - cfg.first_dense_layers)}
    if cfg.first_dense_layers:
        out["dense_layers"] = stack(cfg.first_dense_layers)
    return out


def mesh_cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int) -> dict:
    """``cache_specs`` for a ``DeviceMesh``: the data-parallel axes' and the
    model axis's sizes (1 where the mesh lacks the axis), two data-parallel
    axes when it has ``"pod"`` (``repro``'s ``cache_shardings``)."""
    from repro_torch.launch.mesh import axis_sizes, mesh_dp_size

    return cache_specs(cfg, batch, max_len, dp_size=mesh_dp_size(mesh),
                       model_size=axis_sizes(mesh).get(MODEL, 1),
                       multi_pod=POD in mesh.mesh_dim_names)


def _model_only(spec) -> tuple:
    """A cache leaf's spec without its batch entry: a rank holds its rows
    already, so only the model axis's splits cut the leaf further."""
    return tuple(e if e == MODEL else None for e in spec)


def _new_cache(cfg: ModelConfig, b: int, max_len: int, specs, device) -> dict:
    """Zeros of the cache of ``b`` rows: whole off a mesh, else this rank's
    block of every leaf (raises where a split dim does not divide)."""
    from repro_torch.launch.sharding import local_shape

    out = {}
    for g, tree in cache_shape(cfg, b, max_len).items():
        out[g] = {}
        for k, s in tree.items():
            shape = s.shape if specs is None else local_shape(
                s.shape, _model_only(specs[g][k]), par.active_mesh())
            out[g][k] = torch.zeros(shape, dtype=s.dtype, device=device)
    return out


def _slot(tree: dict, *i) -> dict:
    """One block's entries of a stacked cache group (views)."""
    return {k: t[i] for k, t in tree.items()}


def _put(dst, src, spec, prefix: bool) -> None:
    """Write ``src``, one block's cache entries, into ``dst``, its slot of
    this rank's cache (in place). ``prefix``: ``src`` holds positions [0, L)
    of a cache of ``max_len`` (dim 1), else the whole leaf. On a mesh
    (``spec``, the slot's spec) a dim the model axis splits is cut to this
    rank's block where ``src`` holds it whole (a split position dim: the
    prompt's positions in the rank's block)."""
    if spec is not None:
        ag = par.model_group()
        for d, entry in enumerate(spec):
            if d == 0 or entry != MODEL or ag is None:
                continue
            n = dst.shape[d]
            if prefix and d == 1:
                lo = min(ag.index * n, src.shape[1])
                src = src.narrow(1, lo, min(n, src.shape[1] - lo))
            elif src.shape[d] != n:
                src = src.narrow(d, ag.index * n, n)
    if prefix:
        dst[:, :src.shape[1]] = src
    else:
        dst.copy_(src)


def _specs_for():
    """The cache specs prefill and decode work by: None off a mesh; on one
    those the caller gave ``par.on_mesh``."""
    if not par.active():
        return None
    specs = par.cache_specs()
    if specs is None:
        raise ValueError("prefill and decode on a mesh need the cache's specs: run them "
                         "through ServingEngine(mesh=) (or par.on_mesh(..., cache_specs=))")
    return specs


def _layer_specs(specs, group: str, lead: int):
    """{leaf: spec} of one block's slot of cache group ``group`` (``lead``
    stacked dims dropped), None off a mesh."""
    return None if specs is None else {k: sp[lead:] for k, sp in specs[group].items()}


def _write(tree: dict, idx, entries: dict, lspecs, prefix: bool) -> None:
    for key, t in entries.items():
        _put(tree[key][idx], t, None if lspecs is None else lspecs[key], prefix)


def make_prefill(cfg: ModelConfig, max_len: int):
    """Returns fn(params, tokens, frontend=None) -> (last_logits (B, V),
    cache): the cache holds the attention entries for positions [0, L) and
    zeros up to ``max_len``, as ``_pad_cache_len`` pads, the recurrent state
    after the prompt (each block from a zero state, chunked where L is a
    multiple of ``ssm_chunk`` above 1), and for the vlm and audio families
    the cross-attention's keys and values of ``frontend`` (B,
    n_frontend_tokens, D; the audio encoder runs here, once). Runs under
    ``torch.inference_mode``. On a mesh (``models.parallel``) ``tokens`` and
    ``frontend`` are the rank's rows: it runs tensor-parallel, returns this
    rank's block of the cache and the rows' logits whole over the vocab
    (see the module docstring)."""

    @torch.inference_mode()
    def prefill(params: Transformer, tokens: torch.Tensor, frontend=None):
        b, l = tokens.shape
        if l > max_len:
            raise ValueError(f"prompt length {l} exceeds max_len {max_len}")
        if cfg.family in ("vlm", "audio"):
            frontend = _frontend(cfg, frontend)
            if tuple(frontend.shape) != (b, cfg.n_frontend_tokens, cfg.d_model):
                raise ValueError(f"frontend shape {tuple(frontend.shape)}, the cache wants "
                                 f"{(b, cfg.n_frontend_tokens, cfg.d_model)}")
        specs = _specs_for()
        cache = _new_cache(cfg, b, max_len, specs, tokens.device)
        positions = _positions(l, tokens.device)
        h = embed_tokens(params.embed, tokens)
        if cfg.family == "ssm":
            for i, blk in enumerate(params.layers):
                h, st = rwkv6.apply_rwkv6_block(blk, cfg, h, _slot(cache["layers"], i))
                _write(cache["layers"], i, st, _layer_specs(specs, "layers", 1), False)
        elif cfg.family == "hybrid":
            for idx, g in _hybrid_groups(cfg):
                for i in idx:
                    h, st = mamba2.apply_mamba2_block(params.layers[i], cfg, h,
                                                      _slot(cache["mamba"], i))
                    _write(cache["mamba"], i, st, _layer_specs(specs, "mamba", 1), False)
                if g is not None:
                    h, _, c = _block_seq(params.shared_attn, cfg, h, positions)
                    _write(cache["shared"], g, c, _layer_specs(specs, "shared", 1), True)
        elif cfg.family == "vlm":
            for g, grp in enumerate(params.groups):
                for i, blk in enumerate(grp.self):
                    h, _, c = _block_seq(blk, cfg, h, positions)
                    _write(cache["self"], (g, i), c, _layer_specs(specs, "self", 2), True)
                h, c = _cross_block(grp.cross, cfg, h, positions, frontend)
                _write(cache["cross"], g, c, _layer_specs(specs, "cross", 1), False)
        elif cfg.family == "audio":
            enc = _encode_audio(params, cfg, frontend)
            for i, lyr in enumerate(params.layers):
                h, c, cc = _decoder_layer(lyr, cfg, h, positions, enc)
                _write(cache["self"], i, c, _layer_specs(specs, "self", 1), True)
                _write(cache["cross"], i, cc, _layer_specs(specs, "cross", 1), False)
        else:
            for g, blocks in params.stacks():
                for i, blk in enumerate(blocks):
                    h, _, c = _block_seq(blk, cfg, h, positions)
                    _write(cache[g], i, c, _layer_specs(specs, g, 1), True)
        h = rms_norm(params.final_norm, h[:, -1:])
        logits = unembed(params.embed, h, cfg)[:, 0]
        tp = par.tp_group(params.embed, "tok")
        return (logits if tp is None else par.gather_vocab(logits, tp)), cache

    return prefill


def make_decode_step(cfg: ModelConfig):
    """Returns fn(params, token (B,), cache, pos) -> (logits (B, V), cache).
    The cache is updated in place (at llama3.2-1b's width, batch 64 and 1152
    positions, one 2.4 GB buffer; ``repro`` returns a functional copy) and
    returned; a recurrent state is overwritten by the step's (the per-step
    forms, as ``repro`` decodes); the cross-attention's cache is only read.
    Runs under ``torch.inference_mode``. On a mesh, ``token`` is the rank's
    rows and ``cache`` its blocks, split as the cache specs the caller gave
    ``par.on_mesh`` (``ServingEngine(mesh=)``); the logits come back whole
    over the vocab."""

    @torch.inference_mode()
    def decode(params: Transformer, token: torch.Tensor, cache: dict, pos: int):
        specs = _specs_for()
        pos = int(pos)
        h = embed_tokens(params.embed, token[:, None])
        if cfg.family == "ssm":
            ls = _layer_specs(specs, "layers", 1)
            for i, blk in enumerate(params.layers):
                h, st = rwkv6.apply_rwkv6_block(blk, cfg, h, _slot(cache["layers"], i),
                                                chunked=False)
                _write(cache["layers"], i, st, ls, False)
        elif cfg.family == "hybrid":
            ls, ss = _layer_specs(specs, "mamba", 1), _layer_specs(specs, "shared", 1)
            for idx, g in _hybrid_groups(cfg):
                for i in idx:
                    h, st = mamba2.apply_mamba2_block(params.layers[i], cfg, h,
                                                      _slot(cache["mamba"], i), chunked=False)
                    _write(cache["mamba"], i, st, ls, False)
                if g is not None:
                    h = _block_decode(params.shared_attn, cfg, h, _slot(cache["shared"], g),
                                      pos, ss)
        elif cfg.family == "vlm":
            ss, cs = _layer_specs(specs, "self", 2), _layer_specs(specs, "cross", 1)
            for g, grp in enumerate(params.groups):
                for i, blk in enumerate(grp.self):
                    h = _block_decode(blk, cfg, h, _slot(cache["self"], g, i), pos, ss)
                p = grp.cross
                h = h + attn.apply_cross_attention_decode(
                    p.attn, cfg, rms_norm(p.ln1, h), _slot(cache["cross"], g),
                    None if cs is None else cs["k"])
                h = h + apply_mlp(p.mlp, rms_norm(p.ln2, h))
        elif cfg.family == "audio":
            ss, cs = _layer_specs(specs, "self", 1), _layer_specs(specs, "cross", 1)
            for i, lyr in enumerate(params.layers):
                h = _block_decode(lyr, cfg, h, _slot(cache["self"], i), pos, ss)
                h = h + attn.apply_cross_attention_decode(
                    lyr.cross, cfg, rms_norm(lyr.ln_x, h), _slot(cache["cross"], i),
                    None if cs is None else cs["k"])
        else:
            for g, blocks in params.stacks():
                ls = _layer_specs(specs, g, 1)
                for i, blk in enumerate(blocks):
                    h = _block_decode(blk, cfg, h, _slot(cache[g], i), pos, ls)
        h = rms_norm(params.final_norm, h)
        logits = unembed(params.embed, h, cfg)[:, 0]
        tp = par.tp_group(params.embed, "tok")
        return (logits if tp is None else par.gather_vocab(logits, tp)), cache

    return decode
