#!/usr/bin/env python3
"""Where the bf16 flash forward's time goes on the card: the tensor-core
kernel (``src/repro_torch/kernels/csrc/flash_attention_tc.cu``) timed as it
is and with parts of its work cut out, at chip_smoke.py's RAG prefill shape
(B 64, L = S = 1088) and training shape (B 8, L = S = 2048), causal and not.

    python3 examples/torch_flash_fwd_ablation.py

Each cut is a text substitution in a copy of the kernel's source, built with
the library's nvcc flags (one nvcc per variant, all started together) into
the gitignored ``build/flash_fwd_ablation/`` and loaded in place of the
kernel library while it is timed. The cuts compute wrong results by design:
they tell what a part of the work costs, nothing else; only the uncut kernel
is checked against the plain version here. Needs one CUDA card.

  kernel    the kernel as it is
  no_lo     P V without the lo half of P (P rounded once to bf16): the split's cost
  no_pv     no P V at all
  no_mma    no MMA at all: TMA loads, softmax, the split and the barriers alone
  no_exp2   the softmax's exp2 (the SFU) replaced by its argument
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "flash_fwd_ablation"
SOURCES = ("flash_attention.cu", "flash_attention_tc.cu")
LO = ("hopper::mma_rs_tb<DC>(acc, lo[kk], db);", "")
HI = ("hopper::mma_rs_tb<DC>(acc, hi[kk], db);", "")
S = ("hopper::mma_ss<BN>(sacc, da, db, ks > 0);", "")
EXP2 = ("sacc[i] = exp2_approx(fmaf(sacc[i], sc2, -msc[r]));",
        "sacc[i] = fmaf(sacc[i], sc2, -msc[r]);")
VARIANTS = {"kernel": [], "no_lo": [LO], "no_pv": [LO, HI], "no_mma": [LO, HI, S],
            "no_exp2": [EXP2]}
SHAPES = (  # label, B, L = S, causal; H 32, KV 8, d 64 (llama3.2-1b)
    ("rag causal", 64, 1088, True), ("rag non-causal", 64, 1088, False),
    ("train causal", 8, 2048, True), ("train non-causal", 8, 2048, False))


def build_all() -> dict:
    """{variant: loaded library}, the variants compiled in parallel."""
    procs = {}
    for name, cuts in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = d / "flash_attention_tc.cu"
        text = src.read_text()
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the kernel's source")
            text = text.replace(old, new)
        src.write_text(text)
        cmd = [_build.nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-o",
               str(d / "lib.so"), *(str(d / s) for s in SOURCES)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("flash_attention_fwd_launch", "flash_attention_smem_bytes",
                   "flash_attention_max_d"):
            getattr(lib, fn).argtypes = _build._ARGTYPES[fn]
            getattr(lib, fn).restype = _build._RESTYPES.get(fn, ctypes.c_int)
        libs[name] = lib
    return libs


@contextmanager
def loaded(lib):
    """The wrappers launch from ``lib`` inside the block."""
    _build.library()
    saved = _build._loaded["lib"]
    _build._loaded["lib"] = lib
    try:
        yield
    finally:
        _build._loaded["lib"] = saved


def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_flash_fwd_ablation: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(16)
    for label, b, l, causal in SHAPES:
        mk = lambda heads: torch.randn((b, l, heads, 64), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        q, k, v = mk(32), mk(8), mk(8)
        with loaded(libs["kernel"]):
            out, _ = fa.flash_attention_fwd(q, k, v, causal)
        want, _ = fa.flash_attention_plain(q[:2], k[:2], v[:2], causal, 64**-0.5)
        err = float((out[:2].float() - want.float()).abs().max())
        if err > 2e-2:
            raise SystemExit(f"{label}: the kernel is off by {err:.3g}")
        row = {}
        for name, lib in libs.items():
            with loaded(lib):
                row[name] = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                              enable_gqa=True))
        print(f"{label} B={b} L=S={l}: " + " ".join(f"{n} {ms:.4f}" for n, ms in row.items())
              + f" sdpa {sdpa:.4f} ms (kernel max_abs_err on 2 rows {err:.3g})", flush=True)


if __name__ == "__main__":
    main()
