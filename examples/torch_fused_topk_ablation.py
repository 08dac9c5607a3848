#!/usr/bin/env python3
"""Where the fused hybrid-distance top-k kernel's time goes on the card:
``src/repro_torch/kernels/csrc/fused_topk.cu`` timed as it is and with parts
of its work cut out, at the main path's shapes.

    python3 examples/torch_fused_topk_ablation.py [--parent DIR]

``--parent DIR`` names another ``csrc`` directory holding an earlier form of
the kernel (for example ``src/repro_torch/kernels/csrc`` of a ``git archive``
of the parent commit): it is built, cut and timed beside the repository's in
the same process, on the same inputs. Each cut is a text substitution in a
copy of the sources, built with the library's nvcc flags (one nvcc per
variant, all started together) into the gitignored ``build/fused_topk_ablation/``.
The cut copies compute wrong results by design: they tell what a part of the
work costs, nothing else; the uncut kernels are checked against the plain
version. Needs one CUDA card.

Shapes (a 2^20-doc corpus at d_dense 1024 with 32 / 16 ELL slots, as
chip_smoke.py phase 4 makes it):

  descent_chunk  B 2048, C 1032, k 32: uniform ids over 2^20, 30% PAD (phase 2)
  real_chunk     the same launch as one NN-Descent round hands it, built by
                 ``knn_graph._descent_round_chunk`` from the descent's own graph
  descent_init   B 2048, C 32, k 32: uniform ids, no PAD (the initial graph's rows)
  real_refine    a refinement round's launch (k 12, dense-path weights), built alike
  refine_init    the refinement's first launch: the graph's first 12 neighbours
  search_round   B 1024, C 16, k 16, bias, uniform ids over 2^20
  serve_fp32     B 32, C 24, k 24, bias, over one 2^18-doc segment (phase 5's round)
  serve_twin_fp32  the twin keyword pool's launch: k 16, 50% PAD
  serve_int8, serve_twin_int8  the same two over the segment's int8 storage

Cuts of the PR 16 form (one block per query row, k block-wide arg-max rounds):

  kernel     as it is
  no_select  no selection: the scored row is left in shared memory
  no_sparse  the dense part alone
  no_dense   the two ELL parts alone
  ids_only   no query load, no scoring, no selection: the id reads alone

Cuts of the PR 17 form (the ordered form, a counting sort by id, a scoring
pass holding each row in registers and a selection pass, at or above
``ORDERED_MIN_PAIRS``; one pass below it):

  kernel     as it is
  no_select  no selection (the ordered form's selection kernel does not run)
  no_sparse  the dense part alone
  no_dense   the two ELL parts alone
  no_query   the ordered scoring pass without its query rows' dense loads
  no_row     the ordered scoring pass without its corpus rows' loads
  sort_only  ordered: the counting sort alone; one pass: the ids and the query
             row read, no scoring, no selection
  one_pass, ordered  the uncut kernel in one form at every shape
  vec8, warps8, val_on_match, vec8_val_on_match, pairs32, row_keep  the
             kernel built otherwise: 8 16-byte loads a lane in flight per row
             of the one pass (4 as built), 8 warps a one-pass block above 264
             rows (4), ELL values loaded only where the id matches (with the
             ids), 32 sorted pairs a scoring warp (16), the ordered form's fp32
             rows loaded through ``__ldg`` (evict-first ``__ldcs``, so that
             they leave the query rows in L2); right results, timed at every
             shape

Beside the rate timed with CUDA events, the uncut kernels' device time per
call (chip_smoke.device_ms: the calls queued behind a sleep kernel) is
printed and, at the serving and search shapes, the host's time per call
(enqueue, no sync): a call the host cannot issue faster than the card runs
it is timed at the host's rate.
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
from repro_torch.kernels import fused_topk as ft  # noqa: E402
from repro_torch.kernels.hybrid_distance import corpus_args, query_args  # noqa: E402

OUT = ROOT / "build" / "fused_topk_ablation"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# --- the PR 16 form -----------------------------------------------------------
PR16_SELECT = ("  float* os = out_s + size_t(b) * k;",
               "  if (threadIdx.x < k) { out_s[size_t(b) * k + threadIdx.x] = "
               "scores[threadIdx.x % C]; out_i[size_t(b) * k + threadIdx.x] = 0; }\n"
               "  if (C > 0) return;\n  float* os = out_s + size_t(b) * k;")
PR16 = dict(
    marker="fused_topk_kernel<View><<<B, kThreads",
    cuts={
        "kernel": [],
        "no_select": [("fused_topk.cu", *PR16_SELECT)],
        "no_sparse": [("common.cuh", "return (d + s) + f;", "return d;")],
        "no_dense": [("common.cuh",
                      "const float d = c.finish(warp_sum(c.dense_dot(q.dense, row, lane)), row);",
                      "const float d = 0.f;")],
        "ids_only": [("fused_topk.cu", *PR16_SELECT),
                     ("fused_topk.cu", "v = rt::warp_score(q, corpus, id, lane);",
                      "v = float(id);"),
                     ("fused_topk.cu",
                      "  rt::load_query(q, b, qd, qsi, qsv, qfi, qfv, corpus.dd, psq, pfq);", "")],
    },
    argtypes={"fused_topk_launch": [_P] * 5 + [_I] * 4 + [_P] * 5 + [_L, _I, _I, _I]
              + [_P, _P, _I, _I, _P, _P, _I, _P],
              "fused_topk_q8_launch": [_P] * 5 + [_I] * 4 + [_P] * 6 + [_L, _I, _I, _I]
              + [_P, _P, _I, _I, _P, _P, _I, _P],
              "fused_topk_smem_bytes": [_I] * 4},
)
# --- the PR 17 form ---------------------------------------------------------------
PR17_SELECT = [
    ("fused_topk.cu",
     "  fused_topk_select_kernel<<<B, kSelectWarps * kWarp, 0, st>>>(w, C, k, out_s, out_i);",
     ""),
    ("fused_topk.cu",
     "  select_row(scores, C, k, out_s + size_t(b) * k, out_i + size_t(b) * k, lists);",
     "  if (threadIdx.x < k) out_s[size_t(b) * k + threadIdx.x] = scores[threadIdx.x % C];")]
PR17_SUMS = ("  return (d + s) + f;", "    const float out = (d + s) + f;")
VEC8 = ("fused_topk.cu", "constexpr int kOnePassVec = 4;", "constexpr int kOnePassVec = 8;")
WARPS8 = ("fused_topk.cu", "constexpr int kOnePassWarps = 4;", "constexpr int kOnePassWarps = 8;")
VAL_ON_MATCH = [
    ("fused_topk.cu", "  const float sv = lane < c.ps ? ell_val(c.sv + os) : 0.f;\n", ""),
    ("fused_topk.cu", "  const float fv = lane < c.pf ? ell_val(c.fv + of) : 0.f;\n", ""),
    ("fused_topk.cu", "    if (j >= 0) s = sv * q.sval[j];",
     "    if (j >= 0) s = ell_val(c.sv + os) * q.sval[j];"),
    ("fused_topk.cu", "    if (j >= 0) f = fv * q.fval[j];",
     "    if (j >= 0) f = ell_val(c.fv + of) * q.fval[j];")]
PR17 = dict(
    marker="fused_topk_scatter_kernel<<<",
    cuts={
        "kernel": [],
        "no_select": PR17_SELECT,
        "no_sparse": [("fused_topk.cu", PR17_SUMS[0], "  return d;"),
                      ("fused_topk.cu", PR17_SUMS[1], "    const float out = d;")],
        "no_dense": [("fused_topk.cu", PR17_SUMS[0], "  return s + f;"),
                     ("fused_topk.cu", PR17_SUMS[1], "    const float out = s + f;")],
        "no_query": [("fused_topk.cu",
                      "    float d = row.dot(qa.dense + size_t(b) * qa.dd, qa.dd, lane);",
                      "    float d = float(row.d[0].x);")],
        "no_row": [("fused_topk.cu", "      row.load(corpus, pr.x, lane);",
                    "      row = HeldRow<View>();")],
        "sort_only": PR17_SELECT + [
            ("fused_topk.cu", "  fused_topk_score_kernel<View><<<",
             "  if (C < 0) fused_topk_score_kernel<View><<<"),
            ("fused_topk.cu", "      v = score_row(corpus, q, id, lane);", "      v = float(id);")],
    },
    # the uncut kernel under other wrapper constants
    patches={"one_pass": {"ORDERED_MIN_PAIRS": 2**62}, "ordered": {"ORDERED_MIN_PAIRS": 0}},
    # the uncut kernel built with other sizes (right results; timed at every shape)
    tunes={
        "vec8": [VEC8],
        "warps8": [WARPS8],
        "val_on_match": VAL_ON_MATCH,
        "vec8_val_on_match": [VEC8, *VAL_ON_MATCH],
        "pairs32": [("fused_topk.cu", "constexpr int kPairsPerWarp = 16;",
                     "constexpr int kPairsPerWarp = 32;")],
        "row_keep": [("fused_topk.cu",
                      "      d[u] = i < n4 ? __ldcs(c4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);",
                      "      d[u] = i < n4 ? __ldg(c4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);")],
    },
    argtypes={fn: _build._ARGTYPES[fn] for fn in (
        "fused_topk_launch", "fused_topk_q8_launch", "fused_topk_smem_bytes",
        "fused_topk_workspace_bytes", "fused_topk_ordered_max_dd")},
)
FORMS = {"pr16": PR16, "pr17": PR17}
ABLATED = ("descent_chunk", "real_chunk", "serve_fp32", "serve_int8")


def form_of(csrc: Path) -> str:
    text = (csrc / "fused_topk.cu").read_text()
    for name, form in FORMS.items():
        if form["marker"] in text:
            return name
    raise SystemExit(f"{csrc}: no known form of fused_topk.cu")


def build_all(csrcs: dict) -> dict:
    """{(tag, variant): (form, library)}, all variants compiled in parallel."""
    procs = {}
    for tag, csrc in csrcs.items():
        form = form_of(csrc)
        for name, cuts in {**FORMS[form]["cuts"], **FORMS[form].get("tunes", {})}.items():
            d = OUT / tag / name
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            for fname, old, new in cuts:
                text = (d / fname).read_text()
                if old not in text:
                    raise SystemExit(f"{tag}/{name}: {old!r} is not in {fname}")
                (d / fname).write_text(text.replace(old, new))
            cmd = [_build.nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", "-o",
                   str(d / "lib.so"), str(d / "fused_topk.cu")]
            procs[(tag, name)] = (form, d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (form, d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, argtypes in FORMS[form]["argtypes"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_size_t if fn.endswith("_bytes") else ctypes.c_int
        libs[key] = (form, lib, {})
        if key[1] == "kernel":
            for name, patch in FORMS[form].get("patches", {}).items():
                libs[(key[0], name)] = (form, lib, patch)
    return libs


def call_pr16(lib, q, corpus, ids, k, bias):
    """The PR 16 wrapper's launch, against its own C interface."""
    b, c = ids.shape
    out_s = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=ids.device)
    fn = "fused_topk_q8_launch" if hasattr(corpus, "dense_q") else "fused_topk_launch"
    (qd, qsi, qsv, qfi, qfv, _, dd, psq, pfq) = query_args(q)
    rc = getattr(lib, fn)(qd, qsi, qsv, qfi, qfv, b, dd, psq, pfq, *corpus_args(corpus),
                          ids.data_ptr(), _build.ptr(bias), c, k, out_s.data_ptr(),
                          out_i.data_ptr(), *_build.device_and_stream(out_s))
    _build.check(rc, fn)
    return out_s, out_i


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


def caller(form: str, lib, patch: dict):
    """fn(q, corpus, ids, k, bias) launching ``lib``'s kernel, the wrapper's
    constants set as ``patch`` says."""
    if form == "pr16":
        return lambda *a: call_pr16(lib, *a)

    def call(q, corpus, ids, k, bias):
        saved = {name: getattr(ft, name) for name in patch}
        for name, value in patch.items():
            setattr(ft, name, value)
        try:
            with loaded(lib):
                wrap = ft.fused_topk_int8 if hasattr(corpus, "dense_q") else ft.fused_topk
                return wrap(q, corpus, ids, k, bias)
        finally:
            for name, value in saved.items():
                setattr(ft, name, value)
    return call


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call, enqueue only (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def shapes(full, knn_ids):
    """{label: (queries, corpus, ids, k, bias)} at the main path's shapes."""
    from repro_torch.core.build_pipeline import SINGLE_PATH_WEIGHTS
    from repro_torch.core.usms import PathWeights, quantize_corpus, weighted_query

    gen = torch.Generator(device="cuda").manual_seed(17)
    docs, n = full.docs, full.docs.n
    qw = weighted_query(full.queries, PathWeights.three_path())
    seg = docs[0:cs.N_SEGMENT]
    segq = quantize_corpus(seg)
    real_q, real_ids = cs.real_descent_chunk(docs, knn_ids, 32)
    ref_q, ref_ids = cs.real_descent_chunk(docs, knn_ids, 12, SINGLE_PATH_WEIGHTS[0])
    serve_ids = cs.random_ids(cs.N_SEGMENT, 32, 24, 0.2, gen)
    twin_ids = cs.random_ids(cs.N_SEGMENT, 32, 24, 0.5, gen)
    serve_bias = torch.rand((32, 24), generator=gen, device="cuda")
    return {
        "descent_chunk": (docs[0:2048], docs, cs.random_ids(n, 2048, 1032, 0.3, gen), 32, None),
        "real_chunk": (real_q, docs, real_ids, 32, None),
        "descent_init": (docs[0:2048], docs, cs.random_ids(n, 2048, 32, 0.0, gen), 32, None),
        "real_refine": (ref_q, docs, ref_ids, 12, None),
        "refine_init": (ref_q, docs, knn_ids[0:2048, :12].contiguous(), 12, None),
        "search_round": (qw, docs, cs.random_ids(n, 1024, 16, 0.2, gen), 16,
                         torch.rand((1024, 16), generator=gen, device="cuda")),
        "serve_fp32": (qw[0:32], seg, serve_ids, 24, serve_bias),
        "serve_twin_fp32": (qw[0:32], seg, twin_ids, 16, serve_bias),
        "serve_int8": (qw[0:32], segq, serve_ids, 24, serve_bias),
        "serve_twin_int8": (qw[0:32], segq, twin_ids, 16, serve_bias),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="csrc directory of an earlier form")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_fused_topk_ablation: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    csrcs = {"repo": _build.CSRC}
    if args.parent is not None:
        csrcs = {"parent": args.parent.resolve(), **csrcs}
    t = time.perf_counter()
    libs = build_all(csrcs)
    print(f"built {len(libs)} variants in {time.perf_counter() - t:.1f} s", flush=True)

    from repro_torch.core.knn_graph import KnnConfig
    from repro_torch.core.build_pipeline import nn_descent
    from repro_torch.data.corpus import CorpusConfig, make_corpus

    t = time.perf_counter()
    full = make_corpus(CorpusConfig(n_docs=cs.N_FULL, n_queries=cs.N_QUERIES, n_topics=1024,
                                    d_dense=1024, seed=0))
    knn_ids, _ = nn_descent(full.docs, KnnConfig(), torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"corpus and kNN graph (2^20 docs) in {time.perf_counter() - t:.1f} s", flush=True)
    for label, (q, corpus, ids, k, bias) in shapes(full, knn_ids).items():
        b, c = ids.shape
        live, uniq = cs.pair_stats(ids, corpus.n)
        nbytes, flops = cs.scoring_work(q, corpus, ids, b * k * 8,
                                        0 if bias is None else bias.numel() * 4)
        b_ms, b_by = cs.bound(nbytes, flops)
        s_p, p_p = (ft.fused_topk_int8_plain if hasattr(corpus, "dense_q")
                    else ft.fused_topk_plain)(q, corpus, ids, k, bias)
        counts = torch.unique(ids[(ids >= 0) & (ids < corpus.n)], return_counts=True)[1]
        top = int(torch.sort(counts, descending=True).values[:1024].sum())
        print(f"{label} B={b} C={c} k={k}{' bias' if bias is not None else ''}: live pairs "
              f"{live} unique rows {uniq} pairs per unique row {live / max(uniq, 1):.3f}, "
              f"{top / max(live, 1):.3f} of them on the 1,024 most-wanted rows; bound_ms "
              f"{b_ms:.4f} ({b_by})", flush=True)
        reps = 5 if b * c > 2**20 else 50
        for (tag, name), (form, lib, patch) in libs.items():
            if FORMS[form]["cuts"].get(name) and label not in ABLATED:
                continue
            fn = caller(form, lib, patch)
            if not FORMS[form]["cuts"].get(name):  # the uncut kernel, any wrapper constants
                s_k, p_k = fn(q, corpus, ids, k, bias)
                torch.cuda.synchronize()
                err = float((s_k - s_p).abs()[p_p >= 0].max()) if (p_p >= 0).any() else 0.0
                if not torch.equal(p_k < 0, p_p < 0) or err > cs.TOL:
                    raise SystemExit(f"{tag} {label}: the kernel disagrees ({err:.3g})")
            ms = cs.time_ms(lambda: fn(q, corpus, ids, k, bias), reps)
            line = f"  {tag} {name}: {ms:.4f} ms"
            if name in ("kernel", "one_pass", "ordered"):
                dev = cs.device_ms(lambda: fn(q, corpus, ids, k, bias), reps)
                line += f" device {dev:.4f} ms"
            if label.startswith("serve") or label == "search_round":
                line += f" host {host_us(lambda: fn(q, corpus, ids, k, bias)):.1f} us/call"
            print(line, flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
