"""Does chip_smoke.py's phase 9 make torch.profiler lose a record of phase
7's training step? On one GPU:

    python3 examples/torch_profile_after_text.py [--docs 8192] [--bwd-checks]
        [--prune-profile N] [--no-text]

It builds the kernels (phase 1), then profiles one phase 7 training step
(llama3.2-1b at full width and depth, 8 x 2048 tokens, bf16, flash) with
the profiler's CPU activity off and on; runs phase 9 with ``--docs`` docs
(its stream and deletes cut in proportion; its gates are printed, not
required); with ``--bwd-checks`` then phase 7's backward checks
(``phase_flash_bwd``), as the whole script runs them just before its
profiled step; then profiles the same step again, CPU activity off and on.
Each profiled step prints one JSON line: the flash records by symbol
(``F`` the forward, ``Q`` dQ, ``K`` dK/dV) against the 32 / 16 / 16 the
wrappers count, the records in time order, and what CUPTI says of dropped
records: the count ``cuptiActivityGetNumDroppedRecords`` gives for the
global queue, read through the libcupti the profiler loaded, and the lines
of the profiler's own log (its standard error) that mention dropped
records.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def cupti_dropped() -> int | None:
    """Records CUPTI dropped from its global queue since the last read, or
    None where no libcupti is loaded in this process."""
    with open("/proc/self/maps") as f:
        paths = {ln.split()[-1] for ln in f if "libcupti" in ln}
    if not paths:
        return None
    fn = ctypes.CDLL(sorted(paths)[0]).cuptiActivityGetNumDroppedRecords
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int  # CUptiResult, 0 on success
    n = ctypes.c_size_t(0)
    rc = fn(None, 0, ctypes.byref(n))
    return int(n.value) if rc == 0 else -rc


def profiled(label: str, step, cpu: bool) -> None:
    """One profiled step, its standard error captured at the descriptor."""
    from repro_torch.kernels import flash_attention as fa

    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [w.launches for w in wrappers]
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(mode="w+") as log:
        os.dup2(log.fileno(), 2)
        try:
            _, dt, kernels, order, ends = cs.profiled_step(step, 0.0, cpu=cpu)
            dropped = cupti_dropped()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        log.seek(0)
        lines = [ln.strip() for ln in log if "drop" in ln.lower()]
    print(json.dumps(dict(
        when=label, cpu_activity=cpu, seconds=round(dt, 4),
        records={c: order.count(c) for c in "FQK"},
        launches=[w.launches - b for w, b in zip(wrappers, before)],
        order=order, ends=ends, cupti_dropped_global=dropped, log_lines=lines[:8])), flush=True)


def prune_profile(n_docs: int) -> None:
    """Phase 4's profiler session: the first ``cs.PROFILED_CHUNKS`` prune
    chunks of a build over ``n_docs`` docs, replayed under torch.profiler
    with CPU and CUDA activity (as ``cs.phase_full`` replays them)."""
    import torch

    from repro_torch.core import pruning
    from repro_torch.core.build_pipeline import build_index
    from repro_torch.data.corpus import CorpusConfig, make_corpus

    c = make_corpus(CorpusConfig(n_docs=n_docs, n_queries=8, n_topics=64, d_dense=1024, seed=0))
    with cs.prune_chunks_caught(cs.PROFILED_CHUNKS) as chunks:
        build_index(c.docs)
    replay = lambda: [pruning._prune_chunk(*a, **kw) for a, kw in chunks]  # noqa: E731
    replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    kern = cs.cuda_kernels(prof)
    print(json.dumps(dict(prune_profile_docs=n_docs, chunks=len(chunks),
                          launches=sum(v[0] for v in kern.values()),
                          pairwise_tile=sum(v[0] for k, v in kern.items()
                                            if "pairwise_tile" in k))), flush=True)
    del chunks[:], c
    torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=8192)
    ap.add_argument("--bwd-checks", action="store_true",
                    help="run phase 7's backward checks after phase 9")
    ap.add_argument("--prune-profile", type=int, default=0, metavar="N",
                    help="before phase 9, phase 4's profiled prune chunks over N docs")
    ap.add_argument("--no-text", action="store_true", help="leave phase 9 out")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_state, make_train_step

    cs.phase_device()
    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="flash")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=10))
    state = make_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=cs.TRAIN_SEQ,
                                     global_batch=cs.TRAIN_BATCH, seed=0), device="cuda").batch(0)
    step_fn = make_train_step(cfg, tcfg)
    step = lambda: step_fn(state, batch)
    step()  # warm-up
    for cpu in (False, True):
        profiled("before phase 9", step, cpu)

    label = "after"
    if args.prune_profile:
        prune_profile(args.prune_profile)
        label += f" phase 4's profiled prune chunks over {args.prune_profile} docs,"
    if not args.no_text:
        cut = args.docs / cs.TEXT_DOCS
        cs.TEXT_DOCS = args.docs
        cs.TEXT_STREAM = max(cs.TEXT_STREAM_BATCH, int(cs.TEXT_STREAM * cut) // 256 * 256)
        cs.TEXT_DELETES = max(64, int(cs.TEXT_DELETES * cut))
        try:
            cs.phase_text(collections.defaultdict(
                lambda: {"launches": 0, "max_abs_err": 0.0, "checks": []}))
        except cs.SmokeFailure as e:  # the trace is the question here, not the gates
            print(f"phase 9 at {args.docs} docs: a gate failed: {e}", flush=True)
        torch.cuda.empty_cache()
        label += f" phase 9 at {args.docs} docs"
    if args.bwd_checks:
        cs.phase_flash_bwd(cfg, collections.defaultdict(
            lambda: {"launches": 0, "max_abs_err": 0.0, "checks": []}))
        torch.cuda.empty_cache()
        label += " and phase 7's backward checks"
    for cpu in (False, True):
        profiled(label, step, cpu)


if __name__ == "__main__":
    main()
