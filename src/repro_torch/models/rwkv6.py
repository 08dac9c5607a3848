"""RWKV6 "Finch" (``repro/models/rwkv6.py``): attention-free token mixing
with data-dependent decay, used by rwkv6-7b.

The WKV6 recurrence, per head,

    S_t = Diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t (S_{t-1} + Diag(u) k_t v_t^T),

comes in ``repro``'s two forms, both in float32: ``wkv6_scan`` (the exact
per-step recurrence, which decode takes through ``wkv6_step``) and
``wkv6_chunked`` (prefill and training: within a chunk the interaction
matrix factors into two products with the per-dim decay folded into r and
k, exponents centred on the chunk's middle and clamped at +-``EXP_CLAMP``;
the state carried across chunks by a loop over them).

The clamp is ``repro``'s, fault included (ROADMAP Queue 3): once a chunk's
cumulative log decay passes ~2 ``EXP_CLAMP``, the two clamped factors no
longer multiply to ``exp(lexc_t - lc_s)`` and near-diagonal contributions
come out as 1. At chunk 64 and decays in [0.05, 0.3] the chunked form is
off from the exact scan by ~29; the port reproduces it for parity
(tests/test_torch_ssm.py pins it).

The block keeps two quirks of ``repro``, which are not faults: the
channel-mix width is ``int(3.5 * d)``, not ``cfg.d_ff`` (they agree for both
configs), and the decay LoRA reuses the first stream's ``lora_a[:, :wkv_lora]``
with ``lora_b[4]``.

``rwkv6_block_specs`` splits the time-mix and channel-mix projections over
the model axis (``d`` and ``hidden``) as ``repro``'s do, and on a mesh
(``models.parallel``; training and serving alike) the block is
tensor-parallel over them:

  * time mix: ``wr`` / ``wk`` / ``wv`` / ``wg`` column-parallel, ``wo``
    row-parallel with its partial outputs summed over the model axis. Where
    the model axis divides the heads, each rank runs the WKV recurrence on
    its heads (the decay's ``lora_b`` and ``w0``, ``u`` and ``ln_x`` cut to
    them) and holds their
    ``wkv`` state; else r / k / v / g are gathered and every rank runs every
    head (the state replicated, as ``cache_specs`` keeps it);
  * channel mix: ``wk`` column- and ``wv`` row-parallel over ``hidden``,
    the receptance ``wr`` column-parallel and gathered;
  * the token-shift states ``tm_x`` / ``cm_x`` may be held split over
    ``d`` (``cache_specs``); the block gathers them on use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel as par
from repro_torch.models.attention import TensorSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import P, ShardCtx, dtype_of, ninit, param

EXP_CLAMP = 40.0


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------


def wkv6_step(r, k, v, w, u, s):
    """One step. r/k/v/w: (B, H, K); u: (H, K); s: (B, H, K, V) float32.
    Returns (y (B, H, V), the new state), both float32."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, s + u.float()[None, :, :, None] * kv)
    return y, w[..., None] * s + kv


def wkv6_scan(r, k, v, w, u, s0):
    """The exact recurrence, a step at a time. r/k/v/w: (B, L, H, K); u: (H,
    K); s0: (B, H, K, K). Returns (y (B, L, H, K), s_final), float32."""
    s, ys = s0.float(), []
    for t in range(r.shape[1]):
        y, s = wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, s)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def _chunk_states(decay, chunk_kv, s0):
    """The carry across chunks: S_{c+1} = decay_c S_c + kv_c. decay: (b, nc,
    h, K); chunk_kv: (b, nc, h, K, V). Returns (the state before each chunk
    (b, nc, h, K, V), the final state)."""
    s, before = s0.float(), []
    for c in range(chunk_kv.shape[1]):
        before.append(s)
        s = decay[:, c, ..., None] * s + chunk_kv[:, c]
    return torch.stack(before, dim=1), s


def wkv6_chunked(r, k, v, w, u, s0, chunk: int = 64):
    """Chunk-parallel WKV6 (see the module docstring); L must be a multiple
    of ``chunk``."""
    b, l, h, kdim = r.shape
    if l % chunk:
        raise ValueError(f"L={l} not a multiple of chunk={chunk}")
    nc = l // chunk
    shp = (b, nc, chunk, h, kdim)
    r, k, v, w = (t.float().reshape(shp) for t in (r, k, v, w))

    logw = torch.log(torch.clamp(w, min=1e-38))
    lc = torch.cumsum(logw, dim=2)  # inclusive per-chunk cumulative log decay
    lexc = lc - logw  # exclusive
    mid = lc[:, :, chunk // 2:chunk // 2 + 1]  # per-dim centring

    clamp = lambda x: torch.clamp(x, -EXP_CLAMP, EXP_CLAMP)
    rq = r * torch.exp(clamp(lexc - mid))  # (b, nc, T, h, K)
    kk = k * torch.exp(clamp(mid - lc))

    # intra-chunk: A[t, s] = sum_d rq[t, d] kk[s, d], strictly lower + u-diagonal
    a = torch.einsum("bcthd,bcshd->bchts", rq, kk)
    del rq, kk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=a.device), diagonal=-1)
    a = torch.where(mask, a, torch.zeros((), dtype=a.dtype, device=a.device))
    diag = (r * u.float() * k).sum(-1)  # (b, nc, T, h): repro's (r u) k grouping
    y = torch.einsum("bchts,bcshv->bcthv", a, v) + diag[..., None] * v
    del a, diag

    # inter-chunk state carry
    total = lc[:, :, -1]  # (b, nc, h, K) each chunk's total log decay
    k_scaled = k * torch.exp(clamp(total[:, :, None] - lc))
    chunk_kv = torch.einsum("bcshk,bcshv->bchkv", k_scaled, v)
    del k_scaled
    before, s_fin = _chunk_states(torch.exp(clamp(total)), chunk_kv, s0)

    y = y + torch.einsum("bcthk,bchkv->bcthv", r * torch.exp(clamp(lexc)), before)
    return y.reshape(b, l, h, kdim), s_fin


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = param((d,), dtype, device)
        self.bias = param((d,), dtype, device)

    @torch.no_grad()
    def init(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


class TimeMix(nn.Module):
    """mu_x (d), mu (5, d), lora_a (d, 5 lora), lora_b (5, lora, d), w0 (d)
    and u (H, K) in float32, wr / wk / wv / wg / wo (d, d), ln_x."""

    tp_keys = ("wr", "wk", "wv", "wg", "wo")

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, lora, hd = cfg.d_model, cfg.wkv_lora, cfg.ssm_head_dim
        self.mu_x = param((d,), dtype, device)
        self.mu = param((5, d), dtype, device)
        self.lora_a = param((d, 5 * lora), dtype, device)
        self.lora_b = param((5, lora, d), dtype, device)
        self.w0 = param((d,), torch.float32, device)
        self.u = param((d // hd, hd), torch.float32, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, param((d, d), dtype, device))
        self.ln_x = LayerNorm(d, dtype, device)


class ChannelMix(nn.Module):
    """mu_k, mu_r (d), wk (d, hidden), wv (hidden, d), wr (d, d)."""

    tp_keys = ("wk", "wv", "wr")

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        hidden = int(d * 3.5)
        self.mu_k = param((d,), dtype, device)
        self.mu_r = param((d,), dtype, device)
        self.wk = param((d, hidden), dtype, device)
        self.wv = param((hidden, d), dtype, device)
        self.wr = param((d, d), dtype, device)


class RWKV6Block(nn.Module):
    """Parameters under ``repro``'s keys: ``ln1``, ``ln2`` (scale, bias),
    ``tm`` (time mix), ``cm`` (channel mix)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, dtype, device)
        self.ln2 = LayerNorm(cfg.d_model, dtype, device)
        self.tm = TimeMix(cfg, dtype, device)
        self.cm = ChannelMix(cfg, dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        """``repro``'s ``init_rwkv6_block`` scales; w0 centred at -6 (slow
        decay)."""
        d, lora = cfg.d_model, cfg.wkv_lora
        s, hidden = d**-0.5, int(d * 3.5)
        tm, cm = self.tm, self.cm
        for ln in (self.ln1, self.ln2, tm.ln_x):
            ln.init()
        draws = ((tm.mu_x, 0.02), (tm.mu, 0.02), (tm.lora_a, s), (tm.lora_b, lora**-0.5),
                 (tm.w0, 0.02), (tm.u, 0.02), (tm.wr, s), (tm.wk, s), (tm.wv, s), (tm.wg, s),
                 (tm.wo, s), (cm.mu_k, 0.02), (cm.mu_r, 0.02), (cm.wk, s),
                 (cm.wv, hidden**-0.5), (cm.wr, s))
        for w, scale in draws:
            w.copy_(ninit(generator, w.shape, scale, w.dtype))
        tm.w0.sub_(6.0)


def rwkv6_block_specs(ctx: ShardCtx, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    hidden = int(d * 3.5)
    m_d = ctx.ff(d)
    m_h = ctx.ff(hidden)
    dd = ctx.data(d)
    ln = {"scale": P(None), "bias": P(None)}
    return {
        "ln1": ln,
        "ln2": ln,
        "tm": {
            "mu_x": P(None),
            "mu": P(None, None),
            "lora_a": P(dd, None),
            "lora_b": P(None, None, None),
            "w0": P(None),
            "u": P(None, None),
            "wr": P(dd, m_d),
            "wk": P(dd, m_d),
            "wv": P(dd, m_d),
            "wg": P(dd, m_d),
            "wo": P(m_d, dd),
            "ln_x": ln,
        },
        "cm": {
            "mu_k": P(None),
            "mu_r": P(None),
            "wk": P(dd, m_h),
            "wv": P(m_h, dd),
            "wr": P(dd, m_d),
        },
    }


def _layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm with bias, in float32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p.scale.float() + p.bias.float()).to(x.dtype)


def _group_norm_heads(scale, bias, y, h: int, eps: float = 1e-5):
    """GroupNorm with one group per head over (B, L, H, K); float32 out,
    flattened to (B, L, H K)."""
    b, l, _, kdim = y.shape
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).reshape(b, l, h * kdim)
    return yn * scale.float() + bias.float()


def _ddlerp(tm, x, shifted):
    """Finch's data-dependent token-shift interpolation: the five mixed
    streams (r, k, v, g, w), each x + dx (mu_i + lora_b_i tanh(xxx
    lora_a)_i), computed a stream at a time."""
    dx = shifted - x
    xxx = x + dx * tm.mu_x
    lora = tm.lora_b.shape[1]
    a = torch.tanh(xxx @ tm.lora_a)
    return [x + dx * (tm.mu[i] + a[..., i * lora:(i + 1) * lora] @ tm.lora_b[i])
            for i in range(5)]


def _decay(w0, xw):
    w_raw = w0.float() + xw.float()
    return torch.exp(-torch.exp(torch.clamp(w_raw, -20.0, 4.0)))


def _whole_d(t, d: int):
    """A token-shift state (B, d) the cache holds split over the model axis,
    gathered (inference)."""
    return t if t.shape[-1] == d else par.all_gather(t, par.model_group(), -1)


def _column(x, w, tp):
    """x @ w for a column-parallel ``w`` (``tp``: the replicated input enters
    through ``copy_to``)."""
    return (x if tp is None else par.copy_to(x, tp)) @ w


def apply_rwkv6_block(p: RWKV6Block, cfg: ModelConfig, x, state: dict, *, chunked: bool = True):
    """x: (B, L, D); state {"tm_x": (B, D), "cm_x": (B, D), "wkv": (B, H, K,
    K) float32} (on a mesh: ``tm_x`` / ``cm_x`` whole or this rank's slice
    of D, ``wkv`` whole or this rank's heads). The chunked form runs where
    ``chunked`` and L is a multiple of ``cfg.ssm_chunk`` above 1, else the
    per-step scan. Returns (x, the state after the last position: ``tm_x``
    and ``cm_x`` whole, ``wkv`` of the heads this rank ran)."""
    hd = cfg.ssm_head_dim
    d = cfg.d_model
    h = d // hd
    b, l, _ = x.shape
    tm, cm = p.tm, p.cm
    tp = par.tp_group(tm, "wr")
    heads = tp is not None and h % tp.size == 0  # each rank runs its heads

    # ---- time mix ----
    xin = _layer_norm(p.ln1, x)
    shifted = torch.cat([_whole_d(state["tm_x"], d)[:, None], xin[:, :-1]], dim=1)
    xr, xk, xv, xg, xw = _ddlerp(tm, xin, shifted)
    r, k, v = (_column(xs, w, tp) for xs, w in ((xr, tm.wr), (xk, tm.wk), (xv, tm.wv)))
    g = F.silu(_column(xg, tm.wg, tp))
    lora_w = torch.tanh(xw @ tm.lora_a[:, :cfg.wkv_lora])  # repro's reuse
    lb, w0, u, scale, bias = tm.lora_b[4], tm.w0, tm.u, tm.ln_x.scale, tm.ln_x.bias
    if heads:  # this rank's heads: the replicated pieces cut to them
        lora_w = par.copy_to(lora_w, tp)
        lb, w0, scale, bias = (par.my_slice(t, tp, -1) for t in (lb, w0, scale, bias))
        u = par.my_slice(u, tp, 0)
    elif tp is not None:  # the columns do not fall on heads: every rank runs every head
        r, k, v, g = (par.gather_slice(t, tp, -1) for t in (r, k, v, g))
    w = _decay(w0, lora_w @ lb)
    del xr, xk, xv, xg, xw, lora_w
    hl = r.shape[-1] // hd
    r, k, v, w = (t.reshape(b, l, hl, hd) for t in (r, k, v, w))
    s0 = state["wkv"]
    if s0.shape[1] != hl:  # a whole zero state (the forward) cut to this rank's heads
        s0 = s0.narrow(1, tp.index * hl, hl)

    if chunked and l % cfg.ssm_chunk == 0 and l > 1:
        y, s_fin = wkv6_chunked(r, k, v, w, u, s0, cfg.ssm_chunk)
    else:
        y, s_fin = wkv6_scan(r, k, v, w, u, s0)
    yg = _group_norm_heads(scale, bias, y, hl).to(x.dtype) * g
    if tp is not None and not heads:
        yg = par.my_slice(yg, tp, -1)
    out = yg @ tm.wo
    x = x + (out if tp is None else par.reduce_from(out, tp))

    # ---- channel mix ----
    xin2 = _layer_norm(p.ln2, x)
    shifted2 = torch.cat([_whole_d(state["cm_x"], d)[:, None], xin2[:, :-1]], dim=1)
    dx2 = shifted2 - xin2
    xk2 = xin2 + dx2 * cm.mu_k
    xr2 = xin2 + dx2 * cm.mu_r
    tp_h, tp_r = par.tp_group(cm, "wk"), par.tp_group(cm, "wr")
    kv = torch.square(F.relu(_column(xk2, cm.wk, tp_h))) @ cm.wv
    rr = torch.sigmoid(_column(xr2, cm.wr, tp_r))
    if tp_h is not None:
        kv = par.reduce_from(kv, tp_h)
    if tp_r is not None:
        rr = par.gather_slice(rr, tp_r, -1)
    x = x + rr * kv
    return x, {"tm_x": xin[:, -1], "cm_x": xin2[:, -1], "wkv": s_fin}


def rwkv6_state_shape(cfg: ModelConfig, batch: int) -> dict:
    """The recurrent state of one block: its size does not grow with the
    sequence."""
    d, hd = cfg.d_model, cfg.ssm_head_dim
    dt = dtype_of(cfg)
    return {"tm_x": TensorSpec((batch, d), dt), "cm_x": TensorSpec((batch, d), dt),
            "wkv": TensorSpec((batch, d // hd, hd, hd), torch.float32)}
