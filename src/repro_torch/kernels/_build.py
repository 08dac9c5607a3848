"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library under ``build/repro_torch_kernels/`` (gitignored), named by a hash
of the sources and flags so a stale build is never loaded. Nothing is built
at import: the first launch builds. The C entry points return
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hybrid_distance.cu", "fused_topk.cu", "pairwise_tile.cu", "flash_attention.cu",
           "flash_attention_bwd.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {  # every launch ends (..., int device, void* stream)
    "hybrid_distance_launch": [_P] * 5 + [_I] * 4 + [_P] * 5 + [_L, _I, _I, _I]
    + [_P, _I, _P, _I, _P],
    "hybrid_distance_q8_launch": [_P] * 5 + [_I] * 4 + [_P] * 6 + [_L, _I, _I, _I]
    + [_P, _I, _P, _I, _P],
    "fused_topk_launch": [_P] * 5 + [_I] * 4 + [_P] * 5 + [_L, _I, _I, _I]
    + [_P, _P, _I, _I, _P, _P, _I, _P],
    "fused_topk_q8_launch": [_P] * 5 + [_I] * 4 + [_P] * 6 + [_L, _I, _I, _I]
    + [_P, _P, _I, _I, _P, _P, _I, _P],
    "fused_topk_smem_bytes": [_I, _I, _I, _I],
    "pairwise_tile_launch": [_P] * 5 + [_L, _I, _I, _I] + [_P, _I, _I, _P, _I, _P],
    "pairwise_tile_smem_bytes": [_I, _I, _I],
    "pairwise_tile_max_k": [],
    "flash_attention_fwd_launch": [_P] * 5 + [_I] * 7 + [_L] * 12
    + [_I, ctypes.c_float, _I, _I, _P],
    "flash_attention_smem_bytes": [_I, _I],
    "flash_attention_max_d": [],
    "flash_attention_bwd_dq_launch": [_P] * 7 + [_I] * 7 + [_L] * 15
    + [_I, ctypes.c_float, _I, _I, _P],
    "flash_attention_bwd_dkv_launch": [_P] * 8 + [_I] * 7 + [_L] * 18
    + [_I, ctypes.c_float, _I, _I, _P],
    "flash_attention_bwd_smem_bytes": [_I, _I],
}
_RESTYPES = {
    "fused_topk_smem_bytes": ctypes.c_size_t,
    "pairwise_tile_smem_bytes": ctypes.c_size_t,
    "flash_attention_smem_bytes": ctypes.c_size_t,
    "flash_attention_bwd_smem_bytes": ctypes.c_size_t,
}
MAX_SMEM_BYTES = 232_448  # per block on sm_90, opt-in dynamic shared memory

_lock = threading.Lock()
_loaded: dict = {}  # {"lib": CDLL, "log": str}


def nvcc() -> str:
    """The toolkit's ``nvcc``: on PATH, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile (in parallel, one nvcc per source) and link the library if
    it is not built yet. Returns (path, compiler log)."""
    so = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [cc, *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        log, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"--- {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / so.name
        link = [cc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, so)
    return so, "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    with _lock:
        if "lib" not in _loaded:
            path, log = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _loaded["lib"] = lib
            _loaded["log"] = log
        return _loaded["lib"]


def build_log() -> str:
    """Compiler output (``-Xptxas -v`` resources) of this process's build;
    empty when the library was already built."""
    library()
    return _loaded["log"]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current-stream handle) for a CUDA tensor: the last two
    arguments of every launch. The library links its own CUDA runtime, whose
    current device is not PyTorch's, so each launch sets it."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
