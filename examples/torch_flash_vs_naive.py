"""How far the port's flash and naive attention paths drift apart in bf16,
at llama3.2-1b's full width: the limits of chip_smoke.py's flash-vs-naive
checks come from this script, for prefill (phase 6) and for the training
gradients (phase 7, ``--grads``).

    python3 examples/torch_flash_vs_naive.py --device cpu --layers 1 2 4 8
    python3 examples/torch_flash_vs_naive.py --device cpu --grads --layers 1 2
    python3 examples/torch_flash_vs_naive.py --layers 16   # on a card

For each depth it initializes llama3.2-1b at full width (bf16, random
weights from seed 0) cut to that many layers. Prefill: it prefills the same
random tokens (2 x 1088) once with ``attn_impl="flash"`` and once with
``"naive"``, and prints one JSON line: the max |difference| of the
last-position logits, their max |value|, and the argmax agreement; then the
same reading for each of chip_smoke.py's planted faults in the flash path
(the causal mask off; the last key tile left out), which the limit must
keep out. ``--grads``: the loss gradients (``make_loss_fn``, remat full) on
2 x 2048 tokens of the training pipeline, flash against naive, as the max
over parameters of |g_flash - g_naive| / |g_naive|; then the same for each
of phase 7's planted faults in the backward (dK/dV from the first query
head of each group only; Delta taken as 0; the last key tile's dS dropped).
In bf16 it then prints phase 7's bf16 readings against naive at fp32 copies
of the parameters: flash, naive, and flash with Delta taken from O
recomputed in fp32, which shows how much of flash's drift is O's rounding.
The two paths round at different places in bf16 (naive rounds the scores
and the softmax weights to bf16; flash keeps both in fp32), so they drift
with depth. On the CPU, flash runs its plain versions; on a card, the
kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

from chip_smoke import (  # noqa: E402
    TRAIN_SEQ,
    bf16_readings,
    grad_gap,
    planted_bwd,
    planted_flash,
)

BATCH = 2
LENGTH = 1088  # chip_smoke.py phase 6's prefill: 4 docs x 256 tokens + a 64-token prompt


def grads(cfg, dev) -> None:
    """Phase 7's gradient readings at this depth, sound and planted."""
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=8),
                         device=dev)
    tokens = pipe.batch(0)["tokens"][:BATCH]
    sound = fa.flash_attention_bwd
    for fault in (None, "first_head", "delta", "last_tile"):
        if fault is not None:
            fa.flash_attention_bwd = planted_bwd(fault)
        try:
            gap, where = grad_gap(cfg, params, tokens)
        finally:
            fa.flash_attention_bwd = sound
        print(json.dumps(dict(device=str(dev), layers=cfg.n_layers, dtype=cfg.dtype, batch=BATCH,
                              length=TRAIN_SEQ, planted_fault=fault, grad_gap=gap,
                              parameter=where)), flush=True)
    if cfg.dtype == "bfloat16":
        readings = bf16_readings(cfg, params, tokens)[0]
        for label, (gap, where) in readings.items():
            print(json.dumps(dict(device=str(dev), layers=cfg.n_layers, batch=BATCH,
                                  length=TRAIN_SEQ, reading=label, grad_gap=gap,
                                  parameter=where)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--grads", action="store_true", help="phase 7's training gradients")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = ap.parse_args()
    dev = resolve_device(args.device)
    for n_layers in args.layers:
        cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=n_layers,
                                  attn_impl="flash", dtype=args.dtype)
        if args.grads:
            grads(cfg, dev)
            continue
        gen = torch.Generator(device=dev).manual_seed(0)
        params = tfm.init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab, (BATCH, LENGTH), generator=gen,
                               device=dev, dtype=torch.int32)
        naive, _ = tfm.make_prefill(dataclasses.replace(cfg, attn_impl="naive"),
                                    LENGTH)(params, tokens)
        sound = attention._flash
        for fault, causal, drop in ((None, True, 0), ("causal mask off", False, 0),
                                    ("last key tile dropped", True, 64)):
            if fault is not None:
                attention._flash = planted_flash(flash_attention_fwd, causal, drop)
            try:
                flash, _ = tfm.make_prefill(cfg, LENGTH)(params, tokens)
            finally:
                attention._flash = sound
            diff = (flash.float() - naive.float()).abs()
            print(json.dumps(dict(
                device=str(dev), layers=n_layers, batch=BATCH, length=LENGTH,
                planted_fault=fault, max_abs_diff=float(diff.max()),
                max_abs_logit=float(naive.float().abs().max()),
                argmax_agreement=float((flash.argmax(-1) == naive.argmax(-1)).float().mean()))),
                flush=True)
        del params


if __name__ == "__main__":
    main()
