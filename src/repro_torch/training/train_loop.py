"""Training step on one device (``repro/training/train_loop.py``):
microbatch gradient accumulation, the remat'd model forward, AdamW.

The train state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``,
with the moments keyed by the model's parameter names. ``repro`` donates the
state to a jitted step; the port updates it in place and returns it. The
mesh modes (GSPMD data parallelism and the int8-compressed all-reduce) come
with the multi-GPU slice: a mesh or ``grad_compression=True`` raises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt

_MULTI_GPU = "comes with the multi-GPU slice (ROADMAP Queue 1 item 5)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = opt.OptConfig()
    microbatches: int = 1
    grad_compression: bool = False


def make_train_state(cfg: ModelConfig, tcfg: TrainConfig, generator: torch.Generator,
                     device=None) -> dict:
    """Random parameters from ``generator`` (``tfm.init_params``) and zero
    optimizer state, on ``device`` (``None`` -> CUDA)."""
    params = tfm.init_params(cfg, generator, device)
    return {"params": params, "opt": opt.init_opt_state(dict(params.named_parameters()),
                                                        tcfg.opt)}


def _accumulate_grads(loss_fn, params, batch: dict, n_micro: int):
    """(loss, {name: grad}) over ``n_micro`` microbatches of ``batch`` (B
    must divide by ``n_micro``). One microbatch leaves the gradients in the
    parameters' dtype; several sum them in float32 and scale by 1 / n, as
    ``repro``'s scan does."""
    names, leaves = zip(*params.named_parameters())
    if n_micro == 1:
        loss = loss_fn(params, batch)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} microbatches")
    loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    for i in range(n_micro):
        mb = {k: t.reshape((n_micro, b // n_micro) + t.shape[1:])[i] for k, t in batch.items()}
        loss = loss_fn(params, mb)
        for acc, g in zip(g_sum, torch.autograd.grad(loss, leaves)):
            acc.add_(g.float())
        loss_sum += loss.detach()
    inv = 1.0 / n_micro
    return loss_sum * inv, {n: g * inv for n, g in zip(names, g_sum)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, param_specs_tree=None):
    """Returns fn(state, batch) -> (state, metrics): gradients of
    ``make_loss_fn`` over ``tcfg.microbatches``, then one AdamW update of the
    state in place. ``metrics`` holds 0-d tensors ``loss``, ``lr`` and
    ``grad_norm``."""
    if mesh is not None:
        raise NotImplementedError(f"a device mesh {_MULTI_GPU}")
    if tcfg.grad_compression:
        raise NotImplementedError(f"int8 gradient compression {_MULTI_GPU}")
    loss_fn = tfm.make_loss_fn(cfg)

    def step(state: dict, batch: dict):
        params = state["params"]
        loss, grads = _accumulate_grads(loss_fn, params, batch, tcfg.microbatches)
        metrics = opt.adamw_update(grads, state["opt"], dict(params.named_parameters()),
                                   tcfg.opt)
        metrics["loss"] = loss
        return state, metrics

    return step
