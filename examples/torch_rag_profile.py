"""Where the time of a RAG generation batch goes on one GPU: prefill and
decode of llama3.2-1b at full width (bf16, random weights from a seed),
at chip_smoke.py phase 6's shape, under ``torch.profiler``.

    python3 examples/torch_rag_profile.py     # B 64, L 1088, 16 decode steps

Retrieval is left out (chip_smoke.py phase 6 times it): the prompt is
random tokens of the RAG length. Each phase is warmed up, timed once
without the profiler, then run ``REPS`` times under it; each profiled run
prints one JSON line: the host-clock seconds of that run (ended by a
synchronize) and of the unprofiled one, the device busy seconds under the
profiler (the sum of the CUDA kernels' self time; one stream, so they do not
overlap), the idle share against the profiled run's own window (busy and
wall from the same run) and, beside it, against the unprofiled window, the
count of kernel launches, and the kernels that took the most device time.
The flash-attention launches are counted through the wrapper's
``launches``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402


def device_seconds(prof, top: int = 8):
    """(busy seconds, launches, [(name, ms, calls)] of the top kernels)."""
    rows = []
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key, t / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    return busy, sum(r[2] for r in rows), [(n[:80], round(ms, 3), c) for n, ms, c in rows[:top]]


def window(label, fn, extra=None):
    """Run ``fn`` once to warm up (library handles, GEMM heuristics for these
    shapes), once unprofiled, then ``REPS`` times under the profiler (device
    time only, to add little host cost), one line per profiled run."""
    fn()
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    flash = flash_attention_fwd.launches
    for rep in range(REPS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_profiled = time.perf_counter() - t
        busy, launches, top = device_seconds(prof)
        idle = lambda w: (1 - busy / w) if busy > 0 else "not measured"
        out = dict(phase=label, rep=rep, wall_profiled_s=wall_profiled, wall_s=wall,
                   device_busy_s=busy, idle_share=idle(wall_profiled),
                   idle_share_vs_unprofiled=idle(wall), kernel_launches=launches,
                   flash_launches=flash, top_kernels=top)
        out.update(extra or {})
        print(json.dumps(out), flush=True)


BATCH, LENGTH, STEPS, SEED = 64, 1088, 16, 0  # chip_smoke.py phase 6's batch and prefill
REPS = 3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_rag_profile: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tfm.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (BATCH, LENGTH), generator=gen, device="cuda",
                           dtype=torch.int32)
    max_len = LENGTH + STEPS + 1
    prefill = tfm.make_prefill(cfg, max_len)
    decode = tfm.make_decode_step(cfg)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, tokens)

    def run_decode():
        cur = torch.argmax(state["logits"], dim=-1).to(torch.int32)
        for i in range(STEPS):
            logits, _ = decode(params, cur, state["cache"], LENGTH + i)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)

    window("prefill", run_prefill, dict(batch=BATCH, length=LENGTH))
    window("decode", run_decode, dict(batch=BATCH, steps=STEPS))


if __name__ == "__main__":
    main()
