"""AdamW + LR schedule + global-norm clipping (``repro/training/optimizer.py``).

The numerics are ``repro``'s: fp32 math, the clip scale from the global
norm of the gradients, bias correction, decoupled weight decay on the
parameter, and each parameter rounded once per update to its own dtype.
``moment_dtype`` chooses fp32 or bf16 moments. The port updates the
parameters and moments in place (``repro`` returns new arrays). Parameters
and moments are dicts keyed by the model's parameter names.

On a mesh the moments are split as their parameters (``opt_state_specs``,
so FSDP splits them over the data axis too) and AdamW runs on each rank's
blocks; the clip scale comes from ``global_norm`` of the whole logical
gradients, which a mesh step computes from the blocks (``mesh_global_norm``
in ``training.train_loop``) and passes in.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine decay to ``min_lr_frac * lr``
    at ``total_steps``; float32, on ``step``'s device."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """Zero moments beside each parameter, and step 0 (int32, on the
    parameters' device)."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    zeros = {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()}
    device = next(iter(params.values())).device
    return {
        "m": zeros,
        "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_specs(param_specs: dict) -> dict:
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict, cfg: OptConfig,
                 gnorm: torch.Tensor = None) -> dict:
    """One AdamW step on ``params`` and ``opt_state`` (both updated in place);
    ``grads`` keyed as ``params``; ``gnorm`` the gradients' global norm where
    they are blocks of larger ones (default: ``global_norm`` of ``grads``).
    Returns the metrics ``lr`` and ``grad_norm`` (0-d float32 tensors)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.float()
    c1 = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), stepf)
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        gf = grads[name].float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}
