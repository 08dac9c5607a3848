#!/usr/bin/env python3
"""Where the pair-tile and hybrid-distance kernels' time goes on the card:
``src/repro_torch/kernels/csrc/pairwise_tile.cu`` and ``hybrid_distance.cu``
timed as they are and with parts of their work cut out, at the main path's
shapes.

    python3 examples/torch_pairwise_tile_ablation.py [--parent DIR] [--only KERNEL]

``--parent DIR`` names another ``csrc`` directory holding an earlier form of
the kernels (for example ``src/repro_torch/kernels/csrc`` of a ``git
archive`` of the parent commit): it is built, cut and timed beside the
repository's in the same process, on the same inputs, and its
``fused_topk.cu`` is held bit for bit against the repository's (the two
share the row scorer). Each cut is a text substitution in a copy of the
sources, built with the library's nvcc flags (one nvcc per variant, all
started together) into the gitignored ``build/pairwise_tile_ablation/``. The
cut copies compute wrong results by design: they tell what a part of the
work costs, nothing else; the uncut kernels are checked against the plain
versions. Needs one CUDA card.

Shapes (a 2^20-doc corpus at d_dense 1024 with 32 / 16 ELL slots, as
chip_smoke.py phase 4 makes it, and the NN-Descent graph its build prunes):

  pairwise_tile
    uniform_chunk   1,024 nodes x K 32, uniform ids over 2^20 (phase 2)
    real_chunk      ``knn_ids[0:1024]`` of the descent's graph, clamped to
                    [0, N) as ``ops.pairwise_tile_scores_vs_ids`` clamps them
                    (the first prune chunk of the build)
  hybrid_distance
    self_scores     B 2^20, C 1: ids = arange(N), the query rows the corpus
    path_norm       B 65,536, C 1: rows 0..65,535 under dense-path weights
                    against themselves (one of the build's 48 norm launches)
    entry           B 1,024, C 16: uniform ids (search entry scoring)
    final_rescore   B 3,072, C 80, 30% PAD (the search's final re-score)
    serve_entry, serve_rescore  B 32, C 16 and B 96, C 80 over one 2^18-doc
                    segment, fp32 and int8 (the served launches)
    large           B 2,048, C 1,032, 30% PAD over the segment, fp32 and int8
                    (chip_smoke.py phase 2's large int8 shape)

Cuts of the PR 17 form (``pairwise_tile``: a block per node, rank-sorted
ELL rows, one (i, j) dot per thread over shared-memory tiles, a binary
search per pair; ``hybrid_distance``: a block per query row staging it in
shared memory):

  pairwise_tile    kernel; no_sort; no_sparse; no_dense (the Gram's FMAs);
                   rows_only (the row loads alone)
  hybrid_distance  kernel; no_stage (the query's staging cut, its barrier
                   kept); no_sparse (the dense part alone)

Cuts of the PR 18 form (``pairwise_tile``: persistent blocks, a cp.async
ring of row tiles, the Gram on the tensor cores in 3xTF32, ELL rows sorted
once by a warp, a thread per pair i <= j intersecting by binary search;
``hybrid_distance``: a warp per query row holding it in registers below
``SMALL_C_MAX``, the block form above it):

  pairwise_tile    kernel; no_sort; no_sparse; no_dense (no MMA);
                   one_tf32 (the Gram from the hi parts alone: 1 MMA a
                   product, not 3); rows_only; and built otherwise, with
                   right results: fma (the Gram on the CUDA cores, fp32
                   register micro-tiles), stages2, stages4 (ring depth), bk32
                   (32-float stages), occ5, occ6 (registers capped for 5 or 6
                   blocks an SM, with 2 stages or 32-float ones to fit)
  hybrid_distance  kernel; no_sparse; warp_form, block_form (the uncut
                   kernel in one form at every shape)

Beside the rate timed with CUDA events, the uncut kernels' device time per
call (chip_smoke.device_ms: the calls queued behind a sleep kernel) is
printed.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import hybrid_distance as hd  # noqa: E402
from repro_torch.kernels import pairwise_tile as pt  # noqa: E402
from repro_torch.kernels.hybrid_distance import corpus_args, query_args  # noqa: E402

OUT = ROOT / "build" / "pairwise_tile_ablation"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

PR17_PT_SORT = [
    ("pairwise_tile.cu",
     "    rt::rank_sort_row(ri, rv, ps, s.sid + r * ps, s.sval + r * ps, t, ps);", ""),
    ("pairwise_tile.cu",
     "    rt::rank_sort_row(ri, rv, pf, s.fid + r * pf, s.fval + r * pf, t, pf);", "")]
PR17_PT_SPARSE = [
    ("pairwise_tile.cu", "const float sp = pair_sparse(s.sid, s.sval, s.ns, ps, i, j);",
     "const float sp = 0.f;"),
    ("pairwise_tile.cu", "const float fp = pair_sparse(s.fid, s.fval, s.nf, pf, i, j);",
     "const float fp = 0.f;")]
PR17_PT_DENSE = [("pairwise_tile.cu", "for (int x = 0; x < kTileD; ++x) t += a[x] * bb[x];",
                  "for (int x = 0; x < 1; ++x) t += a[x] * bb[x];")]
PR17 = dict(
    marker=("pairwise_tile.cu", "rt::rank_sort_row(ri, rv, ps"),
    pt_cuts={"kernel": [], "no_sort": PR17_PT_SORT, "no_sparse": PR17_PT_SPARSE,
             "no_dense": PR17_PT_DENSE,
             "rows_only": PR17_PT_SORT + PR17_PT_SPARSE + PR17_PT_DENSE},
    hd_cuts={
        "kernel": [],
        "no_stage": [("hybrid_distance.cu",
                      "  rt::load_query(q, b, qd, qsi, qsv, qfi, qfv, corpus.dd, psq, pfq);",
                      "  if (threadIdx.x == 0) { q.counts[0] = psq; q.counts[1] = pfq; }\n"
                      "  __syncthreads();")],
        "no_sparse": [("common.cuh", "  return (d + s) + f;\n}\n\n}  // namespace rt",
                       "  return d;\n}\n\n}  // namespace rt")],
    },
    argtypes={
        "pairwise_tile_launch": [_P] * 5 + [_L, _I, _I, _I] + [_P, _I, _I, _P, _I, _P],
        "pairwise_tile_smem_bytes": [_I, _I, _I],
        "pairwise_tile_max_k": [],
        "hybrid_distance_launch": [_P] * 5 + [_I] * 4 + [_P] * 5 + [_L, _I, _I, _I]
        + [_P, _I, _P, _I, _P],
        "hybrid_distance_q8_launch": [_P] * 5 + [_I] * 4 + [_P] * 6 + [_L, _I, _I, _I]
        + [_P, _I, _P, _I, _P],
    },
)

# --- the PR 18 form -----------------------------------------------------------------
PR18_PT_SORT = [("pairwise_tile.cu",
                 "if (t == 0) sort_node_ell(p, sm, p.ids + node * K, psp, pfp);", "")]
PR18_PT_SPARSE = [("pairwise_tile.cu", "sparse_round(sm, K, psp, pfp, r);", ";")]
MMA_LO = ("        mma::mma_tf32(part[u], alo, bhi[0], bhi[1]);\n"
          "        mma::mma_tf32(part[u], ahi, blo[0], blo[1]);\n")
MMA_HI = "        mma::mma_tf32(part[u], ahi, bhi[0], bhi[1]);\n"
PR18_PT_DENSE = [("pairwise_tile.cu", MMA_LO + MMA_HI, "")]
# The Gram on the CUDA cores instead: each thread an fp32 register micro-tile
# of rows tid / 8 + 16 a and columns tid % 8 + 8 c (2 x 4 at K 32, 4 x 8 at
# K 64), 16-byte reads of the stage; it takes the place of everything from
# "the Gram" to "the sparse pairs" in pairwise_tile.cu.
GRAM_FMA = r"""// ---- the Gram (fp32 micro-tiles) ----
struct Tiles {
  int rows, cols, nstep, ntiles;  // the micro-tile: rows (Kp / 16) x column steps (Kp / 8)
};

__device__ __forceinline__ Tiles warp_tiles(int kp, int) { return Tiles{kp / 16, kp / 8, 0, 1}; }

template <int T>
__device__ __forceinline__ void gram_step(const float* tile, const Tiles& w, float (&acc)[T][4],
                                          int) {
  constexpr int RA = T == 2 ? 2 : 4, CB = T == 2 ? 4 : 8;
  const int r0 = threadIdx.x / 8, c0 = threadIdx.x % 8;
#pragma unroll 4
  for (int k = 0; k < kBK; k += 4) {
    float4 x[RA], y[CB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
      x[a] = a < w.rows ? *reinterpret_cast<const float4*>(tile + (r0 + 16 * a) * kLd + k)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < CB; ++c)
      y[c] = c < w.cols ? *reinterpret_cast<const float4*>(tile + (c0 + 8 * c) * kLd + k)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CB; ++c)
        acc[(a * CB + c) / 4][(a * CB + c) % 4] +=
            x[a].x * y[c].x + x[a].y * y[c].y + x[a].z * y[c].z + x[a].w * y[c].w;
  }
}

template <int T>
__device__ __forceinline__ void gram_store(float* gram, int K, const Tiles& w, float (&acc)[T][4],
                                           int) {
  constexpr int RA = T == 2 ? 2 : 4, CB = T == 2 ? 4 : 8;
  const int r0 = threadIdx.x / 8, c0 = threadIdx.x % 8;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const int i = r0 + 16 * a, j = c0 + 8 * c;
      float& x = acc[(a * CB + c) / 4][(a * CB + c) % 4];
      if (a < w.rows && c < w.cols && i < K && j < K) gram[i * (K + 1) + j] = x;
      x = 0.f;
    }
}

"""
PR18 = dict(
    marker=("pairwise_tile.cu", "sort_node_ell("),
    pt_cuts={"kernel": [], "no_sort": PR18_PT_SORT, "no_sparse": PR18_PT_SPARSE,
             "no_dense": PR18_PT_DENSE,
             "one_tf32": [("pairwise_tile.cu", MMA_LO, "")],
             "rows_only": PR18_PT_SORT + PR18_PT_SPARSE + PR18_PT_DENSE},
    pt_tunes={
        "stages2": [("pairwise_tile.cu", "constexpr int kStages = 3;",
                     "constexpr int kStages = 2;")],
        "stages4": [("pairwise_tile.cu", "constexpr int kStages = 3;",
                     "constexpr int kStages = 4;")],
        "fma": [("pairwise_tile.cu", ("// ---- the Gram ----", "// ---- the sparse pairs ----"),
                 GRAM_FMA)],
        "bk32": [("pairwise_tile.cu", "constexpr int kBK = 64;", "constexpr int kBK = 32;")],
        "occ5": [("pairwise_tile.cu", "constexpr int kStages = 3;", "constexpr int kStages = 2;"),
                 ("pairwise_tile.cu", "__launch_bounds__(kThreads, T <= 2 ? 4 : 2)",
                  "__launch_bounds__(kThreads, T <= 2 ? 5 : 2)")],
        "occ6": [("pairwise_tile.cu", "constexpr int kBK = 64;", "constexpr int kBK = 32;"),
                 ("pairwise_tile.cu", "__launch_bounds__(kThreads, T <= 2 ? 4 : 2)",
                  "__launch_bounds__(kThreads, T <= 2 ? 6 : 2)")],

    },
    hd_cuts={
        "kernel": [],
        "no_sparse": [("common.cuh", "  return (d + s) + f;  // score_row", "  return d;")],
    },
    hd_patches={"warp_form": {"SMALL_C_MAX": 2**30}, "block_form": {"SMALL_C_MAX": 0}},
    argtypes={fn: _build._ARGTYPES[fn] for fn in _build._ARGTYPES
              if fn.startswith(("pairwise_tile", "hybrid_distance"))},
)
FORMS = {"pr17": PR17, "pr18": PR18}
PT_ABLATED = ("uniform_chunk", "real_chunk")
HD_ABLATED = ("self_scores", "path_norm", "entry")


def form_of(csrc: Path) -> str:
    for name, form in FORMS.items():
        fname, marker = form["marker"]
        if marker in (csrc / fname).read_text():
            return name
    raise SystemExit(f"{csrc}: no known form of pairwise_tile.cu")


def build_all(csrcs: dict) -> dict:
    """{(tag, kernel, variant): (form, library, wrapper patch)}, all variants
    compiled in parallel; with two trees also each tree's fused_topk.cu."""
    procs, todo = {}, {}

    def start(key, csrc, source, cuts):  # every copy is cut before any nvcc starts
        d = OUT / "_".join(key)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        for fname, old, new in cuts:
            text = (d / fname).read_text()
            if isinstance(old, tuple):  # the region from one marker to the next
                if old[0] not in text or old[1] not in text:
                    raise SystemExit(f"{key}: {old!r} is not in {fname}")
                old = text[text.index(old[0]):text.index(old[1])]
            if old not in text:
                raise SystemExit(f"{key}: {old!r} is not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        todo[key] = (d, [_build.nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-o",
                         str(d / "lib.so"), str(d / source)])

    forms = {}
    for tag, csrc in csrcs.items():
        form = forms[tag] = form_of(csrc)
        f = FORMS[form]
        for name, cuts in {**f["pt_cuts"], **f.get("pt_tunes", {})}.items():
            start((tag, "pt", name), csrc, "pairwise_tile.cu", cuts)
        for name, cuts in f["hd_cuts"].items():
            start((tag, "hd", name), csrc, "hybrid_distance.cu", cuts)
        if len(csrcs) > 1:
            start((tag, "topk", "kernel"), csrc, "fused_topk.cu", [])
    for key, (d, cmd) in todo.items():
        procs[key] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for key, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        form = forms[key[0]]
        types = FORMS[form]["argtypes"] if key[1] != "topk" else {
            fn: _build._ARGTYPES[fn] for fn in _build._ARGTYPES if fn.startswith("fused_topk")}
        for fn, argtypes in types.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _build._RESTYPES.get(fn, ctypes.c_int)
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        libs[key] = (form, lib, {})
        if key[1] == "pt" and hasattr(lib, "pairwise_tile_blocks_per_sm"):
            lib.pairwise_tile_blocks_per_sm.argtypes = [_I] * 5
            print(f"{key[0]} pt {key[2]}: {lib.pairwise_tile_blocks_per_sm(32, 1024, 32, 16, 0)} "
                  f"blocks an SM at K 32, Dd 1024; ptxas: " + " | ".join(used), flush=True)
        elif key[2] == "kernel":
            print(f"{key[0]} {key[1]} ptxas: " + " | ".join(used), flush=True)
            if key[1] == "hd":
                for name, patch in FORMS[form].get("hd_patches", {}).items():
                    libs[(key[0], "hd", name)] = (form, lib, patch)
    return libs


@contextmanager
def loaded(lib, module=None, patch=None):
    """The wrappers launch from ``lib`` inside the block, ``module``'s
    constants set as ``patch`` says."""
    _build.library()
    saved_lib = _build._loaded["lib"]
    saved = {name: getattr(module, name) for name in (patch or {})}
    _build._loaded["lib"] = lib
    for name, value in (patch or {}).items():
        setattr(module, name, value)
    try:
        yield
    finally:
        _build._loaded["lib"] = saved_lib
        for name, value in saved.items():
            setattr(module, name, value)


def call_pr17_pt(lib, corpus, ids):
    """The PR 17 wrapper's launch, against its own C interface."""
    nodes, k = ids.shape
    out = torch.empty((nodes, k, k), dtype=torch.float32, device=ids.device)
    rc = lib.pairwise_tile_launch(
        corpus.dense.data_ptr(), corpus.learned.idx.data_ptr(), corpus.learned.val.data_ptr(),
        corpus.lexical.idx.data_ptr(), corpus.lexical.val.data_ptr(), corpus.n,
        corpus.dense.shape[1], corpus.learned.idx.shape[1], corpus.lexical.idx.shape[1],
        ids.data_ptr(), nodes, k, out.data_ptr(), *_build.device_and_stream(out))
    _build.check(rc, "pairwise_tile")
    return out


def call_pr17_hd(lib, q, corpus, ids):
    b, c = ids.shape
    out = torch.empty((b, c), dtype=torch.float32, device=ids.device)
    fn = "hybrid_distance_q8_launch" if hasattr(corpus, "dense_q") else "hybrid_distance_launch"
    (qd, qsi, qsv, qfi, qfv, _, dd, psq, pfq) = query_args(q)
    rc = getattr(lib, fn)(qd, qsi, qsv, qfi, qfv, b, dd, psq, pfq, *corpus_args(corpus),
                          ids.data_ptr(), c, out.data_ptr(), *_build.device_and_stream(out))
    _build.check(rc, fn)
    return out


def caller(kind: str, form: str, lib, patch: dict):
    if form == "pr17":
        return (lambda *a: call_pr17_pt(lib, *a)) if kind == "pt" else (
            lambda *a: call_pr17_hd(lib, *a))
    if kind == "pt":
        def call(corpus, ids):
            with loaded(lib):
                return pt.pairwise_tile(corpus, ids)
        return call

    def call(q, corpus, ids):
        with loaded(lib, hd, patch):
            wrap = hd.hybrid_distance_int8 if hasattr(corpus, "dense_q") else hd.hybrid_distance
            return wrap(q, corpus, ids)
    return call


def pt_shapes(docs, knn_ids):
    gen = torch.Generator(device="cuda").manual_seed(17)
    n = docs.n
    uni = torch.randint(0, n, (1024, 32), generator=gen, device="cuda", dtype=torch.int32)
    uni[0, 5] = uni[0, 6]  # planted identical rows
    real = knn_ids[0:1024, :32].clamp(0, n - 1).to(torch.int32).contiguous()
    return {"uniform_chunk": uni, "real_chunk": real}


def hd_shapes(full):
    from repro_torch.core.build_pipeline import SINGLE_PATH_WEIGHTS
    from repro_torch.core.usms import PathWeights, quantize_corpus, weighted_query

    gen = torch.Generator(device="cuda").manual_seed(19)
    docs, n = full.docs, full.docs.n
    qw = weighted_query(full.queries, PathWeights.three_path())
    seg = docs[0:cs.N_SEGMENT]
    segq = quantize_corpus(seg)
    stack3 = lambda q: type(q)(torch.cat([q.dense] * 3), *(
        type(sv)(torch.cat([sv.idx] * 3), torch.cat([sv.val] * 3))
        for sv in (q.learned, q.lexical)))
    arange = lambda m: torch.arange(m, dtype=torch.int32, device="cuda")[:, None].contiguous()
    s_entry = cs.random_ids(cs.N_SEGMENT, 32, 16, 0.0, gen)
    s_rescore = cs.random_ids(cs.N_SEGMENT, 96, 80, 0.3, gen)
    large = cs.random_ids(cs.N_SEGMENT, 2048, 1032, 0.3, gen)
    return {
        "self_scores": (docs, docs, arange(n)),
        "path_norm": (weighted_query(docs[0:65536], SINGLE_PATH_WEIGHTS[0]), docs, arange(65536)),
        "entry": (qw, docs, cs.random_ids(n, 1024, 16, 0.0, gen)),
        "final_rescore": (stack3(qw), docs, cs.random_ids(n, 3072, 80, 0.3, gen)),
        "serve_entry_fp32": (qw[0:32], seg, s_entry),
        "serve_rescore_fp32": (stack3(qw[0:32]), seg, s_rescore),
        "serve_entry_int8": (qw[0:32], segq, s_entry),
        "serve_rescore_int8": (stack3(qw[0:32]), segq, s_rescore),
        "large_fp32": (docs[cs.N_SEGMENT:cs.N_SEGMENT + 2048], seg, large),
        "large_int8": (docs[cs.N_SEGMENT:cs.N_SEGMENT + 2048], segq, large),
    }


def run_variants(libs, kind, label, args, want, reps, ablated, exact_key):
    """Time every variant of ``kind`` at one shape; the uncut ones checked
    against the plain version (``want``) and, across trees, bit for bit."""
    outs = {}
    for (tag, k, name), (form, lib, patch) in libs.items():
        if k != kind:
            continue
        cut = name in FORMS[form][f"{kind}_cuts"] and name != "kernel"
        if cut and label not in ablated:
            continue
        fn = caller(kind, form, lib, patch)
        if not cut:
            got = fn(*args)
            torch.cuda.synchronize()
            live = torch.isfinite(want)
            err = float((got - want).abs()[live].max()) if live.any() else 0.0
            if not torch.equal(torch.isfinite(got), live) or err > cs.TOL:
                raise SystemExit(f"{tag} {kind} {name} {label}: the kernel disagrees ({err:.3g})")
            again = fn(*args)
            if not torch.equal(got, again):
                raise SystemExit(f"{tag} {kind} {name} {label}: two launches differ")
            outs[(tag, name)] = got
        ms = cs.time_ms(lambda: fn(*args), reps)
        line = f"  {tag} {name}: {ms:.4f} ms"
        if not cut:
            line += f" device {cs.device_ms(lambda: fn(*args), reps):.4f} ms"
        print(line, flush=True)
    if exact_key and len({t for t, _ in outs}) > 1:
        a, b = outs.get(("parent", "kernel")), outs.get(("repo", "kernel"))
        if a is not None and b is not None:
            print(f"  parent vs repo: max |diff| {float((a - b).abs().nan_to_num().max()):.3g}",
                  flush=True)


def topk_bit_identical(libs, full, knn_ids):
    """The parent's and the repository's fused_topk give the same bits."""
    from repro_torch.kernels import fused_topk as ft

    keys = [k for k in libs if k[1] == "topk"]
    if len(keys) < 2:
        return
    import examples.torch_fused_topk_ablation as fa  # the fused top-k's own shapes

    for label, (q, corpus, ids, k, bias) in fa.shapes(full, knn_ids).items():
        outs, times = [], []
        for key in keys:
            lib = libs[key][1]
            with loaded(lib):
                wrap = ft.fused_topk_int8 if hasattr(corpus, "dense_q") else ft.fused_topk
                outs.append(wrap(q, corpus, ids, k, bias))
                times.append(cs.device_ms(lambda: wrap(q, corpus, ids, k, bias), 5))
        same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
        print(f"fused_topk {label}: parent vs repo bit-identical {same}; device ms "
              + " / ".join(f"{t:.4f}" for t in times), flush=True)
        if not same:
            raise SystemExit(f"fused_topk {label}: the parent's and the repository's differ")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="csrc directory of an earlier form")
    ap.add_argument("--only", choices=("pairwise_tile", "hybrid_distance"),
                    help="time one kernel's shapes alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_pairwise_tile_ablation: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    csrcs = {"repo": _build.CSRC}
    if args.parent is not None:
        csrcs = {"parent": args.parent.resolve(), **csrcs}
    t = time.perf_counter()
    libs = build_all(csrcs)
    print(f"built {len(libs)} variants in {time.perf_counter() - t:.1f} s", flush=True)

    from repro_torch.core.build_pipeline import nn_descent
    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.data.corpus import CorpusConfig, make_corpus

    t = time.perf_counter()
    full = make_corpus(CorpusConfig(n_docs=cs.N_FULL, n_queries=cs.N_QUERIES, n_topics=1024,
                                    d_dense=1024, seed=0))
    knn_ids, _ = nn_descent(full.docs, KnnConfig(), torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"corpus and kNN graph (2^20 docs) in {time.perf_counter() - t:.1f} s", flush=True)
    docs, n = full.docs, full.docs.n

    for label, ids in ({} if args.only == "hybrid_distance" else pt_shapes(docs, knn_ids)).items():
        live, uniq = cs.pair_stats(ids, n)
        nodes, k = ids.shape
        nbytes = uniq * cs.row_bytes(docs) + ids.numel() * 4 + nodes * k * k * 4
        flops = 2.0 * docs.dense.shape[1] * nodes * k * k
        b_ms, b_by = cs.bound(nbytes, flops)
        tf32_ms = 3 * flops / cs.TF32_FLOP_PER_S * 1e3
        counts = torch.unique(ids, return_counts=True)[1]
        top = int(torch.sort(counts, descending=True).values[:64].sum())
        print(f"pairwise_tile {label} C={nodes} K={k}: unique rows {uniq}, pairs per unique row "
              f"{live / max(uniq, 1):.3f}, {top / max(live, 1):.3f} of the slots on the 64 "
              f"most-wanted rows; bound_ms {b_ms:.4f} ({b_by}: bytes "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f}, fp32 operations "
              f"{flops / cs.FP32_FLOP_PER_S * 1e3:.4f}, 3xTF32 operations {tf32_ms:.4f})",
              flush=True)
        want = pt.pairwise_tile_plain(docs, ids)
        run_variants(libs, "pt", label, (docs, ids), want, 20, PT_ABLATED, True)
        del want
        torch.cuda.empty_cache()

    hd_cases = {} if args.only == "pairwise_tile" else hd_shapes(full)
    for label, (q, corpus, ids) in hd_cases.items():
        b, c = ids.shape
        nbytes, flops = cs.scoring_work(q, corpus, ids, ids.numel() * 4)
        if label == "self_scores":
            nbytes -= q.n * cs.row_bytes(q)
        b_ms, b_by = cs.bound(nbytes, flops)
        print(f"hybrid_distance {label} B={b} C={c}: bound_ms {b_ms:.4f} ({b_by})", flush=True)
        plain = hd.hybrid_distance_int8_plain if hasattr(corpus, "dense_q") else \
            hd.hybrid_distance_plain
        rows = max(1, 2**18 // c)  # the plain version gathers (rows, C, Dd)
        want = torch.cat([plain(q[s:s + rows], corpus, ids[s:s + rows].contiguous())
                          for s in range(0, b, rows)])
        run_variants(libs, "hd", label, (q, corpus, ids), want, 5 if b * c > 2**18 else 50,
                     HD_ABLATED, True)
        del want
        torch.cuda.empty_cache()

    if args.only is None:
        topk_bit_identical(libs, full, knn_ids)


if __name__ == "__main__":
    main()
