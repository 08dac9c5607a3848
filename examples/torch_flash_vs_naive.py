"""How far the port's flash and naive attention paths drift apart in bf16,
at llama3.2-1b's full width: the limit of chip_smoke.py's flash-vs-naive
prefill check comes from this script.

    python3 examples/torch_flash_vs_naive.py --device cpu --layers 1 2 4 8
    python3 examples/torch_flash_vs_naive.py --layers 16   # on a card

For each depth it initializes llama3.2-1b at full width (bf16, random
weights from seed 0) cut to that many layers, prefills the same random
tokens (2 x 1088) once with ``attn_impl="flash"`` and once with
``"naive"``, and prints one JSON line: the max |difference| of the
last-position logits, their max |value|, and the argmax agreement; then the
same reading for each of chip_smoke.py's planted faults in the flash path
(the causal mask off; the last key tile left out), which the limit must
keep out. The two
paths round at different places in bf16 (naive rounds the scores and the
softmax weights to bf16; flash keeps both in fp32), so they drift with
depth. On the CPU, flash runs its plain version; on a card, the kernel.
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
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

from chip_smoke import planted_flash  # noqa: E402

BATCH = 2
LENGTH = 1088  # chip_smoke.py phase 6's prefill: 4 docs x 256 tokens + a 64-token prompt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    for n_layers in args.layers:
        cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=n_layers,
                                  attn_impl="flash")
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
