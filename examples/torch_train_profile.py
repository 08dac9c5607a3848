"""Where the time of a training step goes on one GPU: llama3.2-1b at full
width and depth (bf16, remat full, flash attention, random weights from a
seed), at chip_smoke.py phase 7's shape (8 x 2048 tokens of the training
pipeline, AdamW), under ``torch.profiler``; ``--arch`` takes another config
(a vlm or audio one with the pipeline's stub frontend), ``--batch`` and
``--seq`` its shape.

    python3 examples/torch_train_profile.py [--arch whisper-large-v3 --batch 8 --seq 448]
        [--first]

It warms up with one step, times one step without the profiler, then runs
``REPS`` steps under it; each profiled step prints one JSON line: the
host-clock seconds of that step (ended by a synchronize) and of the
unprofiled one, the device busy seconds (the sum of the CUDA kernels' self
time; one stream, so they do not overlap), the idle share against the
step's own window and against the unprofiled one, the kernel launches, the
device time by group (the three flash kernels by name, matrix products by
the names cuBLAS gives its kernels, the rest), and the top kernels. With
``--first`` the warm-up step (the process's first; the kernels are built
before it) is profiled too, with the host's activity: its line adds the
host operators by self time.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "examples")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.training.optimizer import OptConfig  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    TrainConfig,
    make_train_state,
    make_train_step,
)
from torch_rag_profile import device_seconds  # noqa: E402

BATCH, LENGTH, SEED, REPS = 8, 2048, 0, 3  # chip_smoke.py phase 7's batch
HOST_TOP = 12  # --first: host operators listed
# the backward by symbol: the bf16 tensor-core kernels (the training path)
# and the fp32 CUDA-core ones
GROUPS = (("flash_fwd", ("flash_fwd_tc_kernel", "flash_fwd_kernel")),
          ("flash_bwd_dq", ("flash_bwd_tc_dq_kernel", "flash_bwd_dq_kernel")),
          ("flash_bwd_dkv", ("flash_bwd_tc_dkv_kernel", "flash_bwd_dkv_kernel")),
          ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")))


def grouped(prof) -> dict:
    """Device ms by group over every CUDA kernel of the profile."""
    out = {name: 0.0 for name, _ in GROUPS} | {"other": 0.0}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if t <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = evt.key.lower()
        group = next((g for g, pats in GROUPS if any(p in key for p in pats)), "other")
        out[group] += t / 1e3
    return {k: round(v, 3) for k, v in out.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=LENGTH)
    ap.add_argument("--first", action="store_true", help="profile the warm-up step too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_train_profile: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config(args.arch), attn_impl="flash")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=10))
    state = make_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                                    frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model))
    batches = [pipe.batch(s) for s in range(2 + REPS)]
    step = make_train_step(cfg, tcfg)
    _build.library()  # the build (nvcc) stays out of the first step

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) if args.first else contextlib.nullcontext() as prof:
        t = time.perf_counter()
        state, _ = step(state, batches[0])
        torch.cuda.synchronize()
        first = time.perf_counter() - t
    if args.first:
        busy, launches, top = device_seconds(prof)
        host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)[:HOST_TOP]
        print(json.dumps(dict(
            arch=cfg.name, batch=args.batch, length=args.seq, rep="first", wall_profiled_s=first,
            device_busy_s=busy, kernel_launches=launches, device_ms_by_group=grouped(prof),
            top_kernels=top, host_self_ms={e.key[:80]: round(e.self_cpu_time_total / 1e3, 3)
                                           for e in host})), flush=True)
    t = time.perf_counter()
    state, _ = step(state, batches[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for rep in range(REPS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            state, metrics = step(state, batches[2 + rep])
            torch.cuda.synchronize()
            wall_profiled = time.perf_counter() - t
        busy, launches, top = device_seconds(prof)
        idle = lambda w: (1 - busy / w) if busy > 0 else "not measured"
        print(json.dumps(dict(
            arch=cfg.name, batch=args.batch, length=args.seq, first_s=first, rep=rep, loss=float(metrics["loss"]),
            wall_profiled_s=wall_profiled, wall_s=wall, device_busy_s=busy,
            idle_share=idle(wall_profiled), idle_share_vs_unprofiled=idle(wall),
            kernel_launches=launches, device_ms_by_group=grouped(prof), top_kernels=top)),
            flush=True)


if __name__ == "__main__":
    main()
