"""Mixture-of-Experts with sort-based capacity dispatch
(``repro/models/moe.py``, the gspmd path ``apply_moe``): tokens are sorted by
expert id, scattered into a dense (E, C, D) buffer, run through one batched
product per projection, and combined by a gather and a weighted sum. No
(N, E, C) one-hot tensors: the dispatch is O(N k) memory.

Used by kimi-k2 (384 routed, top-8) and deepseek-v3 (1 shared + 256 routed,
top-8). Returns the Switch load-balancing auxiliary loss.

Routing follows ``repro`` exactly: a float32 router whatever the model
dtype, softmax in float32, top-k with ties to the lowest expert (a stable
descending sort: ``torch.topk`` does not promise that order), gates
renormalised. Slots at or beyond the capacity C are dropped, not clamped.
The combine differs in one place: ``repro`` scatter-adds each assignment's
weighted output into its token (``.at[tok].add``, one rounding per add in
``x.dtype``); the port gathers each token's k weighted outputs in
assignment order (top-1 first) and sums them in float32 by one reduction,
rounding once to ``x.dtype``: no atomics, so the same inputs give the same
bits. ``apply_moe_ep`` (shard_map expert parallelism) comes with the
multi-GPU slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, apply_mlp, ninit, param


class MoE(nn.Module):
    """Parameters under ``repro``'s keys: router (d, E) float32, w_gate /
    w_up (E, d, F), w_down (E, F, d) and, with shared experts, ``shared``
    (a SwiGLU MLP of width F x n_shared)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = param((d, e), torch.float32, device)
        self.w_gate = param((e, d, f), dtype, device)
        self.w_up = param((e, d, f), dtype, device)
        self.w_down = param((e, f, d), dtype, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, f * cfg.n_shared_experts, dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig) -> None:
        """``repro``'s scales; the experts are drawn one at a time, so the
        float32 draw never holds a whole (E, d, F) stack."""
        d, f = cfg.d_model, cfg.moe_d_ff
        self.router.copy_(ninit(generator, self.router.shape, d**-0.5, torch.float32))
        for w, scale in ((self.w_gate, d**-0.5), (self.w_up, d**-0.5), (self.w_down, f**-0.5)):
            for e in range(w.shape[0]):
                w[e].copy_(ninit(generator, w.shape[1:], scale, w.dtype))
        if cfg.n_shared_experts:
            self.shared.init(generator)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(p, cfg: ModelConfig, xf):
    """xf: (N, D) -> (probs (N, E) float32, gate (N, k) float32
    renormalised, expert_ids (N, k) int64)."""
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    gate, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_ids = gate[:, :cfg.experts_per_token], expert_ids[:, :cfg.experts_per_token]
    return probs, gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), expert_ids


def expert_slots(expert_ids, c: int):
    """Each assignment's slot in its expert's group, in assignment order
    ((N, k) -> (N, k) int64): the rank of the assignment among those to the
    same expert in (token, rank) order; C or more means dropped. Sort-based,
    as ``repro``: a stable argsort by expert, then the group starts by
    ``searchsorted``."""
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) - group_start
    return pos.reshape(expert_ids.shape)


def apply_moe(p, cfg: ModelConfig, x):
    """x: (B, L, D) -> (y (B, L, D), aux_loss float32)."""
    b, l, d = x.shape
    n, k, e = b * l, cfg.experts_per_token, cfg.n_experts
    c = capacity(n, cfg)
    xf = x.reshape(n, d)
    probs, gate, expert_ids = route(p, cfg, xf)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    assign = torch.bincount(expert_ids.reshape(-1), minlength=e).float() / (n * k)
    aux = e * torch.sum(assign * probs.mean(0))

    slot = expert_slots(expert_ids, c)
    kept = slot < c
    # the (E, C + 1, D) buffer's last slot takes every dropped assignment
    # and is cut off: no host sync for a boolean mask
    buf = x.new_zeros((e, c + 1, d))
    tok = torch.arange(n, device=x.device).repeat_interleave(k)
    buf[expert_ids.reshape(-1), slot.reshape(-1).clamp(max=c)] = xf[tok]
    buf = buf[:, :c]

    h = torch.bmm(F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up), p.w_down)

    out = h[expert_ids, slot.clamp(max=c - 1)]  # (N, k, D), assignment order
    w = torch.where(kept, gate, torch.zeros_like(gate)).to(x.dtype)
    y = (out * w[..., None]).sum(1, dtype=torch.float32).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + apply_mlp(p.shared, xf)
    return y.reshape(b, l, d), aux


def apply_moe_ep(p, cfg: ModelConfig, x, axis: str = "model"):
    raise NotImplementedError(
        "moe_impl='ep_manual' is shard_map expert parallelism across devices: it comes with "
        "the multi-GPU slice (ROADMAP Queue 1 item 5)")
