"""int8 gradient quantization (``repro/training/grad_compression.py``).

``quantize_int8`` / ``dequantize_int8`` are ``repro``'s per-tensor absmax
grid. ``compressed_psum_mean``, the error-feedback data-parallel all-reduce
on the int8 payload, needs a collective across GPUs and comes with the
multi-GPU slice.
"""

from __future__ import annotations

import torch


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization. Returns (q int8, scale float32)."""
    gf = g.float()
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(grads, axis_names, residual=None):
    raise NotImplementedError(
        "compressed_psum_mean needs a data-parallel collective across GPUs: it comes "
        "with the multi-GPU slice (ROADMAP Queue 1 item 5)")
