"""Mamba2 (SSD, state-space duality) block (``repro/models/mamba2.py``),
used by zamba2-1.2b.

The scan comes in ``repro``'s two forms, both in float32: ``ssd_chunked``
(prefill and training: within a chunk a product against the masked decay
kernel, the state carried across chunks by a loop over them) and
``ssd_scan`` (the exact per-step recurrence; decode takes it at L = 1).
The decay is a scalar per head, so the log-space factorisation is exact.

``ssd_chunked``'s three-operand einsums are written as pairwise products in
the grouping ``repro``'s einsum takes at the serving shape (opt_einsum's
"optimal" path): the other orders build a (b, c, t, s, h, p) tensor, ~73 GB
at B 64, L 1088, H 64, P 64, where these keep each temporary at ~1.1 GB.

The causal depthwise conv (window ``CONV_W``) is ``CONV_W`` shifted
multiply-adds in float32, rounded once to the model dtype, so no cuDNN
convolution (and none of its TF32) is involved.

On a mesh the block's parameters are replicated over the model axis (only
FSDP splits them), while ``cache_specs`` splits its decode state: the conv
state's channels and the SSM state's heads. Serving there, each rank runs
the scan on the heads whose state it holds and the heads' outputs are
gathered; the conv state is gathered on use (it is ``CONV_W - 1`` rows).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel as par
from repro_torch.models.attention import TensorSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    P,
    RMSNorm,
    ShardCtx,
    dtype_of,
    ninit,
    param,
    rms_norm,
    rmsnorm_specs,
)

CONV_W = 4  # causal depthwise conv window


def _dims(cfg: ModelConfig):
    """(d_inner, N, P, H, conv channels)."""
    d_inner = 2 * cfg.d_model
    n = cfg.ssm_state
    p = cfg.ssm_head_dim
    return d_inner, n, p, d_inner // p, d_inner + 2 * n


class Mamba2Block(nn.Module):
    """Parameters under ``repro``'s keys: norm, in_proj (d, 2 d_inner + 2 N
    + H), conv_w (CONV_W, C), conv_b (C), a_log / d_skip / dt_bias (H)
    float32, gate_norm, out_proj (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_inner, n, _, h, conv_ch = _dims(cfg)
        self.norm = RMSNorm(d, dtype, device)
        self.in_proj = param((d, 2 * d_inner + 2 * n + h), dtype, device)
        self.conv_w = param((CONV_W, conv_ch), dtype, device)
        self.conv_b = param((conv_ch,), dtype, device)
        self.a_log = param((h,), torch.float32, device)
        self.d_skip = param((h,), torch.float32, device)
        self.dt_bias = param((h,), torch.float32, device)
        self.gate_norm = RMSNorm(d_inner, dtype, device)
        self.out_proj = param((d_inner, d), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        """``repro``'s ``init_mamba2_block``: a_log = log(linspace(1, 16, H))."""
        d = cfg.d_model
        d_inner, _, _, h, _ = _dims(cfg)
        self.norm.scale.fill_(1.0)
        self.in_proj.copy_(ninit(generator, self.in_proj.shape, d**-0.5, self.in_proj.dtype))
        self.conv_w.copy_(ninit(generator, self.conv_w.shape, 0.5, self.conv_w.dtype))
        self.conv_b.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32)))
        self.d_skip.fill_(1.0)
        self.dt_bias.zero_()
        self.gate_norm.scale.fill_(1.0)
        self.out_proj.copy_(ninit(generator, self.out_proj.shape, d_inner**-0.5,
                                  self.out_proj.dtype))


def mamba2_block_specs(ctx: ShardCtx, cfg: ModelConfig) -> dict:
    """Only FSDP splits a Mamba2 block (over ``"data"``); the model axis
    replicates it."""
    dd = ctx.data(cfg.d_model)
    return {
        "norm": rmsnorm_specs(),
        "in_proj": P(dd, None),
        "conv_w": P(None, None),
        "conv_b": P(None),
        "a_log": P(None),
        "d_skip": P(None),
        "dt_bias": P(None),
        "gate_norm": rmsnorm_specs(),
        "out_proj": P(None, dd),
    }


def _causal_conv_seq(w, b, x, init_state):
    """Depthwise causal conv. x: (B, L, C); init_state: (B, CONV_W - 1, C).
    Returns (silu(conv + b), the last CONV_W - 1 inputs)."""
    padded = torch.cat([init_state, x], dim=1)
    l = x.shape[1]
    wf = w.float()
    out = padded[:, 0:l].float() * wf[0]
    for j in range(1, CONV_W):
        out.add_(padded[:, j:j + l].float() * wf[j])
    return F.silu(out.to(x.dtype) + b), padded[:, -(CONV_W - 1):]


def _causal_conv_step(w, b, x1, state):
    """One step of the conv. x1: (B, C); state: (B, CONV_W - 1, C)."""
    window = torch.cat([state, x1[:, None]], dim=1)  # (B, CONV_W, C)
    out = (window.float() * w.float()).sum(1).to(x1.dtype)
    return F.silu(out + b), window[:, 1:]


def _chunk_states(total, chunk_state, s0):
    """The carry across chunks: S_{c+1} = exp(total_c) S_c + chunk_state_c.
    total: (b, nc, h); chunk_state: (b, nc, h, p, n). Returns (the state
    before each chunk (b, nc, h, p, n), the final state)."""
    s, before = s0.float(), []
    for c in range(chunk_state.shape[1]):
        before.append(s)
        s = torch.exp(total[:, c])[..., None, None] * s + chunk_state[:, c]
    return torch.stack(before, dim=1), s


def ssd_chunked(x, dt, a_neg, bmat, cmat, s0, chunk: int):
    """Chunked SSD scan. x: (B, L, H, P); dt: (B, L, H); a_neg: (H,)
    negative decay rates; bmat / cmat: (B, L, N); s0: (B, H, P, N). Returns
    (y (B, L, H, P), s_final), float32."""
    b, l, h, pdim = x.shape
    n = bmat.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} not a multiple of chunk={chunk}")
    nc = l // chunk
    x = x.float().reshape(b, nc, chunk, h, pdim)
    dt = dt.float().reshape(b, nc, chunk, h)
    bmat = bmat.float().reshape(b, nc, chunk, n)
    cmat = cmat.float().reshape(b, nc, chunk, n)

    lc = torch.cumsum(dt * a_neg, dim=2)  # (b, nc, T, h) inclusive, <= 0
    xdt = x * dt[..., None]

    # intra-chunk: M[t, s] = (C_t . B_s) exp(lc_t - lc_s), s <= t; (cb decay) xdt
    cb = torch.einsum("bctn,bcsn->bcts", cmat, bmat)
    ldiff = lc[:, :, :, None, :] - lc[:, :, None, :, :]  # (b, nc, t, s, h)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    m = torch.exp(torch.clamp(ldiff, max=0.0)) * mask[:, :, None]
    del ldiff
    m = cb[..., None] * m
    y = torch.einsum("bctsh,bcshp->bcthp", m, xdt)
    del m

    # chunk states: S_c = sum_s exp(lc_T - lc_s) B_s (x dt)_s; (k_decay xdt) B
    total = lc[:, :, -1]  # (b, nc, h)
    k_decay = torch.exp(torch.clamp(total[:, :, None] - lc, max=0.0))  # (b, nc, T, h)
    chunk_state = torch.einsum("bcshp,bcsn->bchpn", k_decay[..., None] * xdt, bmat)
    before, s_fin = _chunk_states(total, chunk_state, s0)

    # inclusive decay: h_t applies a_t to the carried state before C_t reads
    # it; (C exp(lc)) S
    ce = cmat[..., :, None] * torch.exp(lc)[..., None, :]  # (b, nc, t, n, h)
    y = y + torch.einsum("bctnh,bchpn->bcthp", ce, before)
    return y.reshape(b, l, h, pdim), s_fin


def ssd_scan(x, dt, a_neg, bmat, cmat, s0):
    """The exact per-step recurrence. Returns (y (B, L, H, P), s_final),
    float32."""
    s, ys = s0.float(), []
    x, dt, bmat, cmat = x.float(), dt.float(), bmat.float(), cmat.float()
    for t in range(x.shape[1]):
        a_t = torch.exp(dt[:, t] * a_neg[None])  # (B, H)
        s = a_t[..., None, None] * s + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], bmat[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", s, cmat[:, t]))
    return torch.stack(ys, dim=1), s


def _split_proj(cfg: ModelConfig, proj):
    """(z, xBC, dt) of the input projection."""
    d_inner, n, _, _, _ = _dims(cfg)
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def apply_mamba2_block(p: Mamba2Block, cfg: ModelConfig, x_in, state: dict, *,
                       chunked: bool = True):
    """x_in: (B, L, D); state {"conv": (B, CONV_W - 1, C), "ssm": (B, H, P,
    N) float32}, on a mesh its channels and heads whole or this rank's
    block (see the module docstring). The chunked form runs where
    ``chunked`` and L is a multiple of ``cfg.ssm_chunk`` above 1, else the
    per-step scan. Returns (x, the state after the last position: ``conv``
    whole, ``ssm`` of the heads this rank ran)."""
    d_inner, n, pdim, h, conv_ch = _dims(cfg)
    b, l, _ = x_in.shape
    proj = rms_norm(p.norm, x_in) @ p.in_proj
    z, xbc, dt = _split_proj(cfg, proj)
    conv0 = state["conv"]
    if conv0.shape[-1] != conv_ch:
        conv0 = par.all_gather(conv0, par.model_group(), -1)
    xbc, conv_state = _causal_conv_seq(p.conv_w, p.conv_b, xbc, conv0)
    xs = xbc[..., :d_inner].reshape(b, l, h, pdim)
    bmat, cmat = xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:]
    dt = F.softplus(dt.float() + p.dt_bias)
    a_neg, d_skip = -torch.exp(p.a_log), p.d_skip
    ag = None
    if state["ssm"].shape[1] != h:  # this rank's heads
        ag = par.model_group()
        hl = state["ssm"].shape[1]
        xs, dt, a_neg, d_skip = (t.narrow(dim, ag.index * hl, hl) for t, dim in
                                 ((xs, 2), (dt, 2), (a_neg, 0), (d_skip, 0)))
    if chunked and l % cfg.ssm_chunk == 0 and l > 1:
        y, s_fin = ssd_chunked(xs, dt, a_neg, bmat, cmat, state["ssm"], cfg.ssm_chunk)
    else:
        y, s_fin = ssd_scan(xs, dt, a_neg, bmat, cmat, state["ssm"])
    y = y + d_skip[:, None] * xs.float()
    if ag is not None:
        y = par.all_gather(y, ag, 2)
    y = y.reshape(b, l, d_inner).to(x_in.dtype)
    y = rms_norm(p.gate_norm, y * F.silu(z))
    return x_in + y @ p.out_proj, {"conv": conv_state, "ssm": s_fin}


def mamba2_state_shape(cfg: ModelConfig, batch: int) -> dict:
    """The recurrent state of one block: its size does not grow with the
    sequence."""
    _, n, pdim, h, conv_ch = _dims(cfg)
    return {"conv": TensorSpec((batch, CONV_W - 1, conv_ch), dtype_of(cfg)),
            "ssm": TensorSpec((batch, h, pdim, n), torch.float32)}
