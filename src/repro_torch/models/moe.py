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
bits.

On a mesh step (``models.parallel``) the experts are split over the model
axis as ``moe_specs`` says, in two modes:

  * ``apply_moe`` (``moe_impl="gspmd"``) computes what ``repro``'s global
    program computes. Each data-parallel rank routes its block of the batch;
    the capacity is that of the global token count, and slots count in
    global token order: a rank offsets each expert's positions by the
    assignments the ranks before it (row-major) made to that expert, from
    one all-gather of the (E,) counts. The aux loss is built from the
    globally summed counts and router probabilities. Each model rank runs
    its experts on the kept assignments routed to them and the partial
    outputs are summed over the model axis.
  * ``apply_moe_ep`` (``moe_impl="ep_manual"``, ``repro``'s shard_map
    expert parallelism) routes each data-parallel block on its own, with
    the capacity of the block's token count (drops per block), keeps the
    assignments to the rank's experts [r E / m, (r + 1) E / m) and sums the
    outputs over the model axis; its aux loss is the mean over the
    data-parallel ranks of each block's. It needs a mesh.

The shared expert is a tensor-parallel MLP beside either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel as par
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import P, MLP, ShardCtx, apply_mlp, mlp_specs, ninit, param


class MoE(nn.Module):
    """Parameters under ``repro``'s keys: router (d, E) float32, w_gate /
    w_up (E, d, F), w_down (E, F, d) and, with shared experts, ``shared``
    (a SwiGLU MLP of width F x n_shared)."""

    tp_keys = ("w_gate", "w_up", "w_down")

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


def moe_specs(ctx: ShardCtx, cfg: ModelConfig) -> dict:
    e_sh = ctx.heads(cfg.n_experts)  # experts over the model axis (EP)
    dd = ctx.data(cfg.d_model)
    p = {
        "router": P(dd, None),
        "w_gate": P(e_sh, dd, None),
        "w_up": P(e_sh, dd, None),
        "w_down": P(e_sh, None, dd),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_specs(ctx, cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts)
    return p


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


def _expert_counts(expert_ids, e: int):
    """Assignments per expert (E,) int64: ``bincount`` with a shape fixed by
    ``e``, so it also runs on meta tensors (the dry run)."""
    flat = expert_ids.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


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


def _experts(p, cfg: ModelConfig, xf, gate, expert_ids, slot, c: int, tp):
    """The routed experts' weighted outputs (N, D) float32 of the kept
    assignments (slot < ``c``). With ``tp`` this rank holds experts [r E_l,
    (r + 1) E_l): it runs those assigned to them, and the partial sums are
    summed over the model axis (its inputs and gates enter through
    ``copy_to``)."""
    n, d = xf.shape
    k = cfg.experts_per_token
    e_loc = p.w_gate.shape[0]
    local_e = expert_ids
    if tp is not None:
        xf, gate = par.copy_to(xf, tp), par.copy_to(gate, tp)
        local_e = expert_ids - tp.index * e_loc
    mine = (local_e >= 0) & (local_e < e_loc)
    local_e = torch.where(mine, local_e, torch.zeros_like(local_e))
    kept = mine & (slot < c)
    # the (E_l, C + 1, D) buffer's last slot takes every dropped (or other
    # rank's) assignment and is cut off: no host sync for a boolean mask
    buf = xf.new_zeros((e_loc, c + 1, d))
    tok = torch.arange(n, device=xf.device).repeat_interleave(k)
    to = torch.where(mine, slot, torch.full_like(slot, c)).clamp(max=c)
    buf[local_e.reshape(-1), to.reshape(-1)] = xf[tok]
    buf = buf[:, :c]

    h = torch.bmm(F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up), p.w_down)

    out = h[local_e, slot.clamp(max=c - 1)]  # (N, k, D), assignment order
    w = torch.where(kept, gate, torch.zeros_like(gate)).to(xf.dtype)
    y = (out * w[..., None]).sum(1, dtype=torch.float32)
    return y if tp is None else par.reduce_from(y, tp)


def apply_moe(p, cfg: ModelConfig, x):
    """x: (B, L, D) -> (y (B, L, D), aux_loss float32). On a mesh step in
    gspmd mode, the global program over the data-parallel ranks (see the
    module docstring)."""
    b, l, d = x.shape
    n, k, e = b * l, cfg.experts_per_token, cfg.n_experts
    xf = x.reshape(n, d)
    probs, gate, expert_ids = route(p, cfg, xf)
    counts = _expert_counts(expert_ids, e)
    dp = par.dp_group()
    if dp is None:
        c = capacity(n, cfg)
        slot = expert_slots(expert_ids, c)
        # load-balancing aux loss (Switch): E * sum_e f_e * P_e
        assign = counts.float() / (n * k)
        aux = e * torch.sum(assign * probs.mean(0))
    else:
        every = par.all_gather_rows(counts, dp)  # (DP ranks, E), row-major
        n_all = n * dp.size
        c = capacity(n_all, cfg)
        slot = expert_slots(expert_ids, c) + every[:dp.index].sum(0)[expert_ids]
        assign = every.sum(0).float() / (n_all * k)
        aux = e * torch.sum(assign * (par.psum(probs.sum(0), dp) / n_all))
    y = _experts(p, cfg, xf, gate, expert_ids, slot, c, par.tp_group(p, "w_gate")).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + apply_mlp(p.shared, xf)
    return y.reshape(b, l, d), aux


def apply_moe_ep(p, cfg: ModelConfig, x, axis: str = "model"):
    """``repro``'s manual expert parallelism over the model axis (see the
    module docstring): x (B, L, D), this data-parallel rank's block ->
    (y, aux). Raises off a mesh, or where the experts are not split over
    the model axis."""
    if axis != "model":
        raise ValueError(f"expert parallelism runs over the model axis, not {axis!r}")
    if not par.active():
        raise ValueError("moe_impl='ep_manual' is expert parallelism over a device mesh: run "
                         "it on a mesh step (training.train_loop.make_train_step(cfg, tcfg, "
                         "mesh, specs)), or use moe_impl='gspmd' on one device")
    tp = par.tp_group(p, "w_gate")
    if tp is None:
        raise ValueError(f"ep_manual needs the {cfg.n_experts} experts split over the model "
                         "axis (moe_specs)")
    b, l, d = x.shape
    n, k, e = b * l, cfg.experts_per_token, cfg.n_experts
    xf = x.reshape(n, d)
    probs, gate, expert_ids = route(p, cfg, xf)
    assign = _expert_counts(expert_ids, e).float() / (n * k)
    aux = e * torch.sum(assign * probs.mean(0))
    dp = par.dp_group()
    if dp is not None:  # pmean over every axis: the model ranks' agree
        aux = par.psum(aux, dp) / dp.size
    c = capacity(n, cfg)
    y = _experts(p, cfg, xf, gate, expert_ids, expert_slots(expert_ids, c), c, tp).to(x.dtype)
    if cfg.n_shared_experts:
        # the shared expert stays outside the expert-parallel region: a
        # tensor-parallel MLP over its d_ff
        y = y + apply_mlp(p.shared, xf)
    return y.reshape(b, l, d), aux
