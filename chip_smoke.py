#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

  1. device and build: the card's name and power limit, then the five CUDA
     sources built from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
     parallel, into the gitignored ``build/`` directory);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes (Dd = 1024, the corpus caps, B x C of
     NN-Descent chunks and search rounds) plus edge cases (all-PAD rows,
     k > live, planted ties); the int8 variants over an int8 segment of
     2^18 rows at the shapes a served 32-row bucket gives them and at a
     large shape, with a zero row and a row at +-127 among the candidates;
     max-abs-error, agreement up to ties, times and bounds;
  3. small end-to-end: N = 4096 docs with the KG, built and searched once
     through the kernels and once through the plain versions;
  4. full width: make_corpus at N = 2^20, d_dense = 1024, build_index with
     the default BuildConfig (no KG: the dense (E, E) entity adjacency would
     be ~1 TB), search 1024 queries under six fusion specs, QPS and recall;
  5. serving at full width: the same corpus as four sealed segments of 2^18
     (build_pool_segment + append_segment, one fp32 group) and its int8
     twin, each served through HybridSearchService (default ServiceConfig)
     under three-path, RRF and keyword-constrained specs: QPS, p50/p99
     request latency, recall@10 against brute force over all 2^20 docs,
     nDCG@10, the index-bytes gauges, compiles, and the launches of every
     kernel variant while each pool served (each pool must run its own
     variants and not the other's); then int8 storage against fp32 apart
     from the graph: brute-force top-10 overlap and the score gap against
     the gap the format allows, with planted faults that must fail;
  6. RAG at full width: llama3.2-1b (16 layers, d_model 2048, bf16, random
     weights from a seed) with flash attention behind RagPipeline, retrieving
     through HybridSearchService over phase 4's 2^20-doc index: 64 requests
     of 4 retrieved docs x 256 context tokens + a 64-token prompt (prefill
     L = 1088), 64 tokens generated greedily. First the flash kernel against
     its plain version at the RAG shape (bf16, and fp32 on 4 rows) and at
     edge shapes, with its time, bound and the scaled_dot_product_attention
     call's time; then the main path (retrieval, prefill and decode times,
     16 flash launches per prefill), retrieval through the service against
     direct search, finite prefill logits, and flash prefill against naive
     prefill on 8 rows, with two planted faults that must fail that check;
  7. training at full width: llama3.2-1b (16 layers, d_model 2048, bf16,
     remat full, random weights from a seed) with flash attention through
     make_train_step, on TokenPipeline batches of 8 x 2048 tokens, AdamW
     (lr 3e-4, 2 warm-up steps): first the two backward kernels against
     their plain version at the training shape (bf16, timed beside the
     plain version and the scaled_dot_product_attention backward; fp32 on 2
     rows) and at edge shapes; then one warm-up step and 8 timed steps
     (seconds, tokens/s, loss, grad norm, lr, peak memory, and exactly 32 /
     16 / 16 forward / dQ / dK-dV launches per step), a first loss near
     ln(vocab) and a last one below it; then the loss gradients through
     flash against naive on 2 rows, with three planted faults in the
     backward that must each fail that check;
  8. the kernels line: launches on each variant's path (phases 4 and 6 plus
     the fp32 pool's serving for the fp32 variants, phase 4 for
     pairwise_tile, the int8 pool's serving for the int8 variants, phases 6
     and 7 for flash_attention_fwd, phase 7 for the backward kernels),
     errors, times and bounds at the shape the path runs most;
  9. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs one CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16, tensor cores, dense
TOL = 1e-4  # fp32 sums of ~1000 products in another order than the plain version
N_FULL = 2**20
N_QUERIES = 1024
N_SEGMENT = 2**18  # phase 5: the 2^20 corpus as four sealed segments
RECALL_GAP = 0.02  # int8 three-path recall@10 must stay within this of fp32 (ROADMAP Queue 1)
# int8-stored brute-force top-10 overlap with fp32's: sound 0.9996, planted
# scale faults 0.0009 and 0.9769 on an H100 at 2^20 (PERF.md, Findings PR 12)
INT8_OVERLAP = 0.99
# phase 6: RAG at llama3.2-1b's full width
RAG_REQUESTS, RAG_PROMPT, RAG_GEN = 64, 64, 64
RAG_TOP_K, RAG_CTX = 4, 256  # prefill L = 4 * 256 + 64 = 1088
RAG_MAX_LEN = 1152
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_flash_attention.py:40
# flash vs naive prefill, bf16, max |last-position logit difference| over 8
# rows (logits reach ~4.4). CPU rehearsal (examples/torch_flash_vs_naive.py,
# batch 2, L = 1088): sound 0.039 / 0.050 / 0.055 / 0.084 at 1 / 2 / 4 / 8
# layers; planted faults at 2-8 layers 1.39-4.36 (last key tile dropped,
# causal mask off). On an H100 at 16 layers: sound 0.0898, faults 1.543
# (tile dropped) and 5.812 (causal off) (PERF.md, Findings); phase 6 reads
# both faults against the limit in every run
PREFILL_GAP = 0.25
# phase 7: training at llama3.2-1b's full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 8, 2048, 8  # one warm-up step, then 8 timed
# backward kernels vs the plain version, elementwise |g - w| <= atol + rtol |w|
# as (atol, rtol): fp32 at tests/test_flash_attention.py:64's gradient
# tolerance; bf16 within one bf16 ulp of each value (2^-7 |w|; both sides sum
# in fp32 and round once) plus 2e-4 for the fp32 cancellation in dP - Delta,
# as tests/test_torch_gpu.py holds them (readings in PERF.md, Findings)
GRAD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-4, 2.0**-7)}
# flash vs naive loss gradients at full width on 2 x 2048 tokens, fp32 copies
# of the trained parameters: max over parameters of |g_flash - g_naive| /
# |g_naive|. CPU rehearsal (examples/torch_flash_vs_naive.py --grads --dtype
# float32): sound 4.3e-7 / 7.3e-7 at 1 / 2 layers; planted faults 0.87-0.90
# (dK/dV from the first head of each group), 0.20-2.17 (Delta = 0), 0.0109-
# 0.0114 (last key tile's dS dropped). In bf16 the two paths drift apart by
# 0.0087 at one layer (they round at different places), above the last-tile
# fault's own share, so the gate reads fp32 and bf16 is printed beside it (at
# 16 layers on an H100, flash reads 0.48 from fp32 naive, 0.11 with Delta
# taken from an fp32 O, as naive's own 0.11: PERF.md, Findings)
GRAD_GAP = 1e-3


class SmokeFailure(Exception):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def row_bytes(f) -> int:
    """Bytes of one stored row: fp32 dense + 8 B per ELL slot, or int8 dense
    + a 4-byte scale + 6 B per ELL slot (int32 id, fp16 value)."""
    slots = f.learned.idx.shape[1] + f.lexical.idx.shape[1]
    if hasattr(f, "dense_q"):
        return f.dense_q.shape[1] + 4 + slots * 6
    return f.dense.shape[1] * 4 + slots * 8


def bound(bytes_moved: float, flops: float, flop_rate: float = FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    tb, tf = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def scoring_work(q, corpus, ids, out_bytes: int, extra_in: int = 0):
    """Bytes each input read once (unique live corpus rows, query rows, ids),
    output once; flops of the live (query, row) pairs' dense products."""
    import torch

    live = ids[ids >= 0]
    uniq = int(torch.unique(live).numel())
    nbytes = uniq * row_bytes(corpus) + q.n * row_bytes(q) + ids.numel() * 4 + out_bytes + extra_in
    flops = 2.0 * q.dense.shape[1] * int(live.numel())
    return nbytes, flops


# ---------------------------------------------------------------------------
# agreement checks
# ---------------------------------------------------------------------------


def topk_agree(ks, kp, ps, pp, full_plain, tol: float) -> float:
    """Kernel top-k (ks, kp) vs plain (ps, pp), up to ties: the same slots are
    empty, scores agree per rank, and every kernel pick has, under the plain
    scores, the score of the plain pick at that rank. Returns max |ks - ps|."""
    import torch

    need(torch.equal(kp < 0, pp < 0), "top-k: empty slots differ")
    live = pp >= 0
    err = float((ks - ps).abs()[live].max().item()) if live.any() else 0.0
    need(err <= tol, f"top-k: score error {err} > {tol}")
    need(bool((ks[~live] == ps[~live]).all()), "top-k: sentinel scores differ")
    picked = torch.gather(full_plain, 1, kp.clamp(min=0).long())
    gap = (picked - ps).abs()[live]
    need(gap.numel() == 0 or float(gap.max().item()) <= tol, "top-k: picks differ beyond ties")
    srt = torch.sort(kp.masked_fill(kp < 0, -1), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    need(not bool(dup.any()), "top-k: a position picked twice")
    return err


def ids_agree(ids_a, s_a, ids_b, s_b, tol: float) -> None:
    """Search results agree up to ties: same empty slots, scores per rank
    within tol, and where ids differ the scores at that rank are tied."""
    import torch

    need(torch.equal(ids_a < 0, ids_b < 0), "search: empty slots differ")
    live = ids_a >= 0
    if live.any():
        err = float((s_a - s_b).abs()[live].max().item())
        need(err <= tol, f"search: score error {err}")
    differ = (ids_a != ids_b) & live
    frac = float(differ.float().mean().item())
    need(frac <= 0.01, f"search: {frac:.4f} of result slots differ")


def row_set_agreement(a, b) -> float:
    """Fraction of rows whose live ids are equal as sets."""
    import torch

    sa = torch.sort(a.masked_fill(a < 0, 2**30), dim=1).values
    sb = torch.sort(b.masked_fill(b < 0, 2**30), dim=1).values
    return float((sa == sb).all(dim=1).float().mean().item())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 1 device: {card}")
    say(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in strict fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t = time.perf_counter()
    _build.library()
    used = [ln.strip() for ln in _build.build_log().splitlines() if "Used" in ln]
    say(f"phase 1 build: {time.perf_counter() - t:.1f} s; ptxas: " + " | ".join(used))
    return card


def random_ids(n: int, b: int, c: int, pad_frac: float, gen):
    import torch

    ids = torch.randint(0, n, (b, c), generator=gen, device="cuda", dtype=torch.int32)
    pad = torch.rand((b, c), generator=gen, device="cuda") < pad_frac
    return ids.masked_fill(pad, -1)


def phase_kernels(corpus, queries, results: dict):
    """Each kernel vs its plain version on the card."""
    import torch

    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.usms import FusedVectors, PathWeights, SparseVec, weighted_query
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_plain
    from repro_torch.kernels.hybrid_distance import hybrid_distance, hybrid_distance_plain
    from repro_torch.kernels.pairwise_tile import pairwise_tile, pairwise_tile_plain
    from repro_torch.kernels.ref import NEG

    gen = torch.Generator(device="cuda").manual_seed(7)
    n = corpus.n
    qw = weighted_query(queries, PathWeights.three_path())
    rows = lambda s, e: FusedVectors(
        corpus.dense[s:e], SparseVec(corpus.learned.idx[s:e], corpus.learned.val[s:e]),
        SparseVec(corpus.lexical.idx[s:e], corpus.lexical.val[s:e]))

    def record(name, shape, err, ms, plain_ms, nbytes, flops):
        b_ms, b_by = bound(nbytes, flops)
        results.setdefault(name, {"max_abs_err": 0.0, "checks": []})
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        results[name]["checks"].append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                                            bound_ms=b_ms, bound_by=b_by))
        say(f"phase 2 {name} {shape}: max_abs_err {err:.3g} ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")

    # --- fused_topk: NN-Descent chunk, descent init, search round + edges ---
    sp = SearchParams()
    cases = [
        ("descent_chunk", rows(0, 2048), random_ids(n, 2048, 32 * 32 + 8, 0.3, gen), 32, None),
        ("descent_init", rows(0, 2048), random_ids(n, 2048, 32, 0.0, gen), 32, None),
        ("search_round", qw, random_ids(n, N_QUERIES, 16, 0.2, gen), 16,
         torch.rand((N_QUERIES, 16), generator=gen, device="cuda")),
    ]
    for label, q, ids, k, bias in cases:
        b = ids.shape[0]
        if label == "search_round":  # edge rows: all PAD, k > live, planted ties
            ids[0] = -1
            ids[1, :3] = torch.tensor([11, 22, 33], dtype=torch.int32, device="cuda")
            ids[1, 3:] = -1
            ids[2] = 12345 % n
            ids[3, ::2] = 777 % n
            bias[2:4] = 0.0
        s_k, p_k = fused_topk(q, corpus, ids, k, bias)
        s_p, p_p = fused_topk_plain(q, corpus, ids, k, bias)
        full = hybrid_distance_plain(q, corpus, ids)
        if bias is not None:
            full = full + bias
        full = torch.where(ids >= 0, full, torch.full_like(full, NEG))
        err = topk_agree(s_k, p_k, s_p, p_p, full, TOL)
        if label == "search_round":
            need(bool((p_k[0] == -1).all()) and bool((s_k[0] == NEG).all()), "all-PAD row")
            need(bool((p_k[1, 3:] == -1).all()) and bool((p_k[1, :3] >= 0).all()), "k > live")
            need(torch.equal(p_k[2], torch.arange(k, device="cuda", dtype=torch.int32)),
                 "planted ties: lowest position first")
            tied = p_k[3][p_k[3] % 2 == 0]  # the repeated id sits at even positions
            need(torch.equal(tied, torch.sort(tied).values), "planted ties: order")
        reps = 5 if label == "descent_chunk" else 20
        ms = time_ms(lambda: fused_topk(q, corpus, ids, k, bias), reps)
        plain_ms = time_ms(lambda: fused_topk_plain(q, corpus, ids, k, bias), 2, warm=1)
        nbytes, flops = scoring_work(q, corpus, ids, b * k * 8,
                                     0 if bias is None else bias.numel() * 4)
        record("fused_topk", f"{label} B={b} C={ids.shape[1]} k={k}"
               f"{' bias' if bias is not None else ''}", err, ms, plain_ms, nbytes, flops)
        torch.cuda.empty_cache()

    # --- hybrid_distance: self scores over N, entry scoring, final re-score ---
    self_ids = torch.arange(n, dtype=torch.int32, device="cuda")[:, None]
    stack3 = lambda q: FusedVectors(  # the final re-score's three query blocks
        torch.cat([q.dense] * 3),
        *(SparseVec(torch.cat([sv.idx] * 3), torch.cat([sv.val] * 3))
          for sv in (q.learned, q.lexical)))
    rescore_q = stack3(qw)
    cases = [
        ("self_scores", corpus, self_ids),
        ("entry_scoring", qw, random_ids(n, N_QUERIES, 16, 0.0, gen)),
        ("final_rescore", rescore_q, random_ids(n, 3 * N_QUERIES, sp.pool_size + sp.kw_pool_size,
                                                0.3, gen)),
    ]
    for label, q, ids in cases:
        out_k = hybrid_distance(q, corpus, ids)
        out_p = hybrid_distance_plain(q, corpus, ids)
        need(torch.equal(torch.isinf(out_k), ids < 0), f"hybrid_distance {label}: -inf mask")
        live = ids >= 0
        err = float((out_k - out_p).abs()[live].max().item())
        need(err <= TOL, f"hybrid_distance {label}: error {err}")
        ms = time_ms(lambda: hybrid_distance(q, corpus, ids), 5 if label == "self_scores" else 20)
        plain_ms = time_ms(lambda: hybrid_distance_plain(q, corpus, ids), 2, warm=1)
        nbytes, flops = scoring_work(q, corpus, ids, ids.numel() * 4)
        if label == "self_scores":  # query rows are the corpus rows: read once
            nbytes -= q.n * row_bytes(q)
        record("hybrid_distance", f"{label} B={ids.shape[0]} C={ids.shape[1]}", err, ms,
               plain_ms, nbytes, flops)
        torch.cuda.empty_cache()

    # --- pairwise_tile: one RNG-IP prune chunk -----------------------------
    ids = torch.randint(0, n, (1024, 32), generator=gen, device="cuda", dtype=torch.int32)
    ids[0, 5] = ids[0, 6]  # planted identical rows
    out_k = pairwise_tile(corpus, ids)
    out_p = pairwise_tile_plain(corpus, ids)
    err = float((out_k - out_p).abs().max().item())
    need(err <= TOL, f"pairwise_tile: error {err}")
    need(torch.equal(out_k[0, 5], out_k[0, 6]), "pairwise_tile: identical rows differ")
    ms = time_ms(lambda: pairwise_tile(corpus, ids), 10)
    plain_ms = time_ms(lambda: pairwise_tile_plain(corpus, ids), 2, warm=1)
    uniq = int(torch.unique(ids).numel())
    nbytes = uniq * row_bytes(corpus) + ids.numel() * 4 + ids.shape[0] * 32 * 32 * 4
    flops = 2.0 * corpus.dense.shape[1] * ids.shape[0] * 32 * 32
    record("pairwise_tile", "prune_chunk C=1024 K=32", err, ms, plain_ms, nbytes, flops)
    torch.cuda.empty_cache()

    # --- int8 variants over one sealed segment's storage ---------------------
    from repro_torch.core.usms import quantize_corpus
    from repro_torch.kernels.fused_topk import fused_topk_int8, fused_topk_int8_plain
    from repro_torch.kernels.hybrid_distance import (
        hybrid_distance_int8,
        hybrid_distance_int8_plain,
    )

    seg = rows(0, N_SEGMENT)
    dense = seg.dense.clone()
    dense[0] = 0.0  # a zero row: scale 1.0, all-zero int8
    dense[1, 0::2], dense[1, 1::2] = 1.0, -1.0  # a row at +-127
    cq = quantize_corpus(FusedVectors(dense, seg.learned, seg.lexical))
    del dense
    need(float(cq.dense_scale[0]) == 1.0 and not bool(cq.dense_q[0].any()), "int8: zero row")
    need(bool((cq.dense_q[1].abs() == 127).all()), "int8: +-127 row")
    nq = cq.n
    big_q = rows(N_SEGMENT, N_SEGMENT + 2048)  # rows of another segment as queries

    def plant(ids):
        """Edge rows: all PAD, k > live, planted ties, the zero and +-127 rows."""
        ids[0] = -1
        ids[1, :3] = torch.tensor([11, 22, 33], dtype=torch.int32, device="cuda")
        ids[1, 3:] = -1
        ids[2] = 12345 % nq
        ids[3, ::2] = 777 % nq
        ids[4, :2] = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
        return ids

    # serving shapes: a 32-row bucket with keywords on expands one node per
    # round into 16 semantic + 8 keyword edges (C = 24), picks the round's
    # top 24 and the twin pool's top 16; entry scoring takes the 16 entry
    # points; the final re-score stacks the three single-path queries
    # (B = 96) over the 64 + 16 pooled ids (C = 80)
    sb = 32
    serve_c = sp.expand * (BuildConfig().prune.degree + BuildConfig().prune.keyword_degree)
    bias_for = lambda b, c: torch.rand((b, c), generator=gen, device="cuda")
    cases = [
        ("serve_round", qw[0:sb], plant(random_ids(nq, sb, serve_c, 0.2, gen)),
         min(sp.pool_size, serve_c), bias_for(sb, serve_c)),
        ("serve_twin", qw[0:sb], plant(random_ids(nq, sb, serve_c, 0.5, gen)),
         min(sp.kw_pool_size, serve_c), bias_for(sb, serve_c)),
        ("search_round", qw[0:64], plant(random_ids(nq, 64, 16, 0.2, gen)), 16,
         bias_for(64, 16)),
        ("large", big_q, random_ids(nq, 2048, 32 * 32 + 8, 0.3, gen), 32, None),
    ]
    for label, q, ids, k, bias in cases:
        b = ids.shape[0]
        if bias is not None:
            bias[2:4] = 0.0
        s_k, p_k = fused_topk_int8(q, cq, ids, k, bias)
        s_p, p_p = fused_topk_int8_plain(q, cq, ids, k, bias)
        full = hybrid_distance_int8_plain(q, cq, ids)
        if bias is not None:
            full = full + bias
        full = torch.where(ids >= 0, full, torch.full_like(full, NEG))
        err = topk_agree(s_k, p_k, s_p, p_p, full, TOL)
        if label != "large":
            need(bool((p_k[0] == -1).all()) and bool((s_k[0] == NEG).all()), "int8: all-PAD row")
            need(bool((p_k[1, 3:] == -1).all()) and bool((p_k[1, :3] >= 0).all()), "int8: k > live")
            need(torch.equal(p_k[2], torch.arange(k, device="cuda", dtype=torch.int32)),
                 "int8: planted ties, lowest position first")
            tied = p_k[3][p_k[3] % 2 == 0]
            need(torch.equal(tied, torch.sort(tied).values), "int8: planted ties, order")
        ms = time_ms(lambda: fused_topk_int8(q, cq, ids, k, bias), 5 if b > 256 else 20)
        plain_ms = time_ms(lambda: fused_topk_int8_plain(q, cq, ids, k, bias), 2, warm=1)
        nbytes, flops = scoring_work(q, cq, ids, b * k * 8,
                                     0 if bias is None else bias.numel() * 4)
        record("fused_topk_int8", f"{label} B={b} C={ids.shape[1]} k={k}"
               f"{' bias' if bias is not None else ''}", err, ms, plain_ms, nbytes, flops)
        torch.cuda.empty_cache()

    cases = [
        ("serve_entry", qw[0:sb], plant(random_ids(nq, sb, BuildConfig().n_entry, 0.0, gen))),
        ("serve_rescore", stack3(qw[0:sb]), plant(random_ids(nq, 3 * sb, sp.pool_size + sp.kw_pool_size,
                                                0.3, gen))),
        ("final_rescore", qw[0:64], plant(random_ids(nq, 64, sp.pool_size + sp.kw_pool_size,
                                                     0.3, gen))),
        ("large", big_q, random_ids(nq, 2048, 32 * 32 + 8, 0.3, gen)),
    ]
    for label, q, ids in cases:
        out_k = hybrid_distance_int8(q, cq, ids)
        out_p = hybrid_distance_int8_plain(q, cq, ids)
        need(torch.equal(torch.isinf(out_k), ids < 0), f"hybrid_distance_int8 {label}: -inf mask")
        live = ids >= 0
        err = float((out_k - out_p).abs()[live].max().item())
        need(err <= TOL, f"hybrid_distance_int8 {label}: error {err}")
        ms = time_ms(lambda: hybrid_distance_int8(q, cq, ids), 5 if ids.shape[0] > 256 else 20)
        plain_ms = time_ms(lambda: hybrid_distance_int8_plain(q, cq, ids), 2, warm=1)
        nbytes, flops = scoring_work(q, cq, ids, ids.numel() * 4)
        record("hybrid_distance_int8", f"{label} B={ids.shape[0]} C={ids.shape[1]}", err, ms,
               plain_ms, nbytes, flops)
        torch.cuda.empty_cache()


def phase_small_e2e():
    """N = 4096 with the KG: kernels vs plain versions for build and search."""
    import dataclasses

    import torch

    from repro_torch.core.build_pipeline import build_index
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams, search
    from repro_torch.data.corpus import CorpusConfig, make_corpus

    c = make_corpus(CorpusConfig(n_docs=4096, n_queries=64, n_topics=64, d_dense=1024,
                                 seed=3))
    cfg_k = BuildConfig()
    cfg_p = dataclasses.replace(
        cfg_k, knn=dataclasses.replace(cfg_k.knn, use_kernel=False),
        prune=dataclasses.replace(cfg_k.prune, use_kernel=False))
    kg = dict(kg_triplets=c.kg.triplets, doc_entities=c.doc_entities,
              n_entities=c.kg.n_entities)
    t = time.perf_counter()
    ik = build_index(c.docs, cfg_k, generator=torch.Generator("cuda").manual_seed(1), **kg)
    torch.cuda.synchronize()
    tk = time.perf_counter() - t
    t = time.perf_counter()
    ip = build_index(c.docs, cfg_p, generator=torch.Generator("cuda").manual_seed(1), **kg)
    torch.cuda.synchronize()
    tp = time.perf_counter() - t
    sem = row_set_agreement(ik.semantic_edges, ip.semantic_edges)
    kw = row_set_agreement(ik.keyword_edges, ip.keyword_edges)
    need(sem >= 0.99 and kw >= 0.99, f"small build: row agreement sem {sem} kw {kw}")
    kwds = torch.as_tensor(c.query_keywords)
    ents = torch.as_tensor(c.query_entities)
    for name, spec, params in [
        ("three_path+kw+kg", FusionSpec.weighted(1, 1, 1, kg=30.0),
         SearchParams(use_keywords=True, use_kg=True)),
        ("rrf", FusionSpec.rrf(), SearchParams()),
    ]:
        rk = search(ik, c.queries, spec, params, keywords=kwds, entities=ents)
        rp = search(ik, c.queries, spec, dataclasses.replace(params, use_kernel=False),
                    keywords=kwds, entities=ents)
        ids_agree(rk.ids, rk.scores, rp.ids, rp.scores, TOL)
    say(f"phase 3 small e2e N=4096 Dd=1024 KG on: build kernels {tk:.1f} s plain {tp:.1f} s; "
        f"semantic rows equal {sem:.4f} keyword rows equal {kw:.4f}; search ids agree up to ties")


def phase_full(corpus_bundle, results: dict):
    import dataclasses

    import torch

    from repro_torch.core.build_pipeline import build_index
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.search import SearchParams, search
    from repro_torch.core.usms import weighted_query
    from repro_torch.data.corpus import ndcg_at_k, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance
    from repro_torch.kernels.pairwise_tile import pairwise_tile

    c = corpus_bundle
    n = c.docs.n
    wrappers = {"hybrid_distance": hybrid_distance, "fused_topk": fused_topk,
                "pairwise_tile": pairwise_tile}
    specs = [
        ("dense_only", FusionSpec.weighted(1, 0, 0), SearchParams()),
        ("three_path", FusionSpec.three_path(), SearchParams()),
        ("minmax", FusionSpec.minmax(), SearchParams()),
        ("zscore", FusionSpec.zscore(), SearchParams()),
        ("rrf", FusionSpec.rrf(), SearchParams()),
        ("keyword", FusionSpec.three_path(), SearchParams(use_keywords=True)),
    ]
    kwds = torch.as_tensor(c.query_keywords)

    # ---- the main path: counts zeroed just before, read just after --------
    for w in wrappers.values():
        w.launches = 0
    report = {}
    t = time.perf_counter()
    index = build_index(c.docs, report=report)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    build_launches = {k: w.launches for k, w in wrappers.items()}
    search(index, c.queries[0:64], FusionSpec.three_path(), SearchParams())  # warm-up
    runs = {}
    for name, spec, params in specs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = search(index, c.queries, spec, params, keywords=kwds)
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t)
    launches = {k: w.launches for k, w in wrappers.items()}
    for k, v in launches.items():
        results[k]["launches"] = v
        need(v > 0, f"{k} was not launched on the main path")

    st = report["stage_seconds"]
    say("phase 4 build N=%d Dd=%d: %.2f s total; " % (n, c.docs.dense.shape[1], build_s)
        + " ".join(f"{k} {v:.2f} s" for k, v in st.items()))
    say(f"phase 4 main-path launches: {json.dumps(launches)} (build "
        f"{json.dumps(build_launches)}, then 7 searches: a 64-query warm-up and six "
        f"1024-query specs)")

    # ---- structure ---------------------------------------------------------
    sem = index.semantic_edges
    live = sem >= 0
    need(bool(((sem >= -1) & (sem < n)).all()), "edges out of range")
    own = torch.arange(n, device=sem.device)[:, None]
    need(not bool((live & (sem == own)).any()), "self-edges")
    srt = torch.sort(sem.masked_fill(~live, -1), dim=1).values
    need(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()), "duplicate edges")
    need(bool(live.any(dim=1).all()), "a node without edges")
    kwe = index.keyword_edges
    need(bool(((kwe >= -1) & (kwe < n)).all()), "keyword edges out of range")
    say(f"phase 4 structure: semantic edges (N, {sem.shape[1]}) in range, no self-edges, "
        f"no duplicates, every row non-empty (mean live {live.sum(1).float().mean():.2f}); "
        f"keyword edges mean live {(kwe >= 0).sum(1).float().mean():.2f}")

    # ---- kNN recall@32 on 256 sampled nodes --------------------------------
    gen = torch.Generator(device="cuda").manual_seed(11)
    sample = torch.randperm(n, generator=gen, device="cuda")[:256]
    knn = report["knn_ids"][sample]
    scores = ops.pairwise_scores_chunked(c.docs[sample], c.docs, chunk=32768)
    scores[torch.arange(256, device="cuda"), sample] = float("-inf")
    truth = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :32]
    hits = (knn[:, :, None].long() == truth[:, None, :]).any(-1).sum().item()
    say(f"phase 4 kNN recall@32 (256 sampled nodes vs brute force): {hits / (256 * 32):.4f}")
    del scores

    # ---- search quality and throughput --------------------------------------
    for name, spec, params in specs:
        res, secs = runs[name]
        need(res.ids.shape == (N_QUERIES, params.k), f"{name}: ids shape")
        ok = res.ids >= 0
        need(bool(torch.isfinite(res.scores[ok]).all()), f"{name}: non-finite scores")
        need(bool(ok[:, 0].all()), f"{name}: a query without results")
        truth = ops.topk_hybrid(weighted_query(c.queries, spec.weights), c.docs, 10,
                                chunk=8192)[1]
        rec = recall_at_k(res.ids, truth)
        nd = ndcg_at_k(res.ids, c.query_relevant, 10)
        say(f"phase 4 search {name}: {N_QUERIES} queries {secs:.3f} s QPS "
            f"{N_QUERIES / secs:.1f} vector recall@10 {rec:.4f} nDCG@10 {nd:.4f} "
            f"mean expanded {res.expanded.float().mean():.1f}")

    # ---- 64 queries through the plain versions -------------------------------
    q64 = c.queries[0:64]
    for name in ("three_path", "keyword"):
        _, spec, params = next(s for s in specs if s[0] == name)
        rk = runs[name][0]
        rp = search(index, q64, spec, dataclasses.replace(params, use_kernel=False),
                    keywords=kwds[:64])
        ids_agree(rk.ids[:64], rk.scores[:64], rp.ids, rp.scores, TOL)
    say("phase 4 plain check: 64 queries through the plain versions agree up to ties")
    return index


def phase_serving(corpus_bundle, results: dict, device: str = "cuda"):
    """Four sealed segments of 2^18 docs, fp32 and int8, served through
    HybridSearchService. (``device`` lets the phase be rehearsed on the CPU
    at a tiny size.)"""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.distributed import SegmentedIndex
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.segment_pool import (
        SegmentPool,
        alive_docs_pool,
        append_segment,
        build_pool_segment,
    )
    from repro_torch.core.usms import SparseVec, quantize_corpus, weighted_query
    from repro_torch.data.corpus import ndcg_at_k, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_topk, fused_topk_int8
    from repro_torch.kernels.hybrid_distance import hybrid_distance, hybrid_distance_int8
    from repro_torch.kernels.pairwise_tile import pairwise_tile
    from repro_torch.obs.metrics import GLOBAL
    from repro_torch.serving.hybrid_service import HybridSearchService

    c = corpus_bundle
    n = c.docs.n
    wrappers = {"hybrid_distance": hybrid_distance, "hybrid_distance_int8": hybrid_distance_int8,
                "fused_topk": fused_topk, "fused_topk_int8": fused_topk_int8,
                "pairwise_tile": pairwise_tile}

    # ---- build: four sealed fp32 segments, then the int8 twin --------------
    t = time.perf_counter()
    pool = SegmentPool(groups=[])
    for s in range(n // N_SEGMENT):
        lo, hi = s * N_SEGMENT, (s + 1) * N_SEGMENT
        seg = build_pool_segment(c.docs[lo:hi], np.arange(lo, hi), BuildConfig(),
                                 generator=torch.Generator(device).manual_seed(100 + s),
                                 device=device)
        pool, g = append_segment(pool, seg)
        need(g == 0, "equal-capacity segments must share one group")
        del seg
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    pool_q = SegmentPool(groups=[SegmentedIndex(dataclasses.replace(
        g.index, corpus=quantize_corpus(g.index.corpus)), g.global_ids) for g in pool.groups])
    sync()
    quant_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    say(f"phase 5 pool: {pool.n_segments} segments of {N_SEGMENT} in {pool.n_groups} group, "
        f"built in {build_s:.2f} s; int8 twin quantized in {quant_s:.3f} s")

    kwds = np.asarray(torch.as_tensor(c.query_keywords).cpu())
    specs = [("three_path", FusionSpec.three_path(), None),
             ("rrf", FusionSpec.rrf(), None),
             ("keyword", FusionSpec.three_path(), kwds)]
    truth_cache: dict = {}

    def truth(spec):
        key = tuple(float(torch.as_tensor(getattr(spec.weights, f)))
                    for f in ("dense", "sparse", "full"))
        if key not in truth_cache:
            truth_cache[key] = ops.topk_hybrid(weighted_query(c.queries, spec.weights), c.docs,
                                               10, chunk=8192)[1]
        return truth_cache[key]

    out, launches = {}, {}
    index_bytes = GLOBAL.get("allanpoe_index_bytes_total")
    for dtype, p in (("float32", pool), ("int8", pool_q)):
        index_bytes.reset()  # only this service's labels
        svc = HybridSearchService(p, SearchParams(use_keywords=True, corpus_dtype=dtype))
        gauges = {f"{leaf}/{dt}": int(v) for (leaf, dt), v in index_bytes.values().items()}
        _ = svc.path_stats  # corpus stats once, before the timed requests
        hist = svc.metrics.get("allanpoe_serving_request_latency_seconds")
        for w in wrappers.values():  # each pool's path: counts zeroed just before
            w.launches = 0
        rows = {}
        for name, spec, kw in specs:
            before = hist.snapshot()
            sync()
            t = time.perf_counter()
            res = svc.search(c.queries, spec, keywords=kw)
            secs = time.perf_counter() - t
            lat = hist.snapshot().minus(before)
            ids = res.ids.to(device)
            need(res.ids.shape == (N_QUERIES, 10), f"phase 5 {dtype} {name}: ids shape")
            ok = res.ids >= 0
            need(bool(torch.isfinite(res.scores[ok]).all()), f"phase 5 {dtype} {name}: scores")
            need(bool(ok[:, 0].all()), f"phase 5 {dtype} {name}: a query without results")
            rec = recall_at_k(ids, truth(spec))
            nd = ndcg_at_k(ids, c.query_relevant, 10)
            rows[name] = dict(qps=N_QUERIES / secs, p50_ms=lat.quantile(0.5) * 1e3,
                              p99_ms=lat.quantile(0.99) * 1e3, recall=rec, ndcg=nd, res=res)
            say(f"phase 5 serve {dtype} {name}: {N_QUERIES} queries {secs:.3f} s QPS "
                f"{N_QUERIES / secs:.1f} p50 {lat.quantile(0.5) * 1e3:.2f} ms p99 "
                f"{lat.quantile(0.99) * 1e3:.2f} ms vector recall@10 {rec:.4f} nDCG@10 {nd:.4f}")
        launches[dtype] = {k: w.launches for k, w in wrappers.items()}  # read just after
        buckets = svc.metrics.get("allanpoe_serving_batches_total").values()
        need(svc.stats.compiles == len(buckets),
             f"phase 5 {dtype}: {svc.stats.compiles} compiles for {len(buckets)} bucket shapes")
        say(f"phase 5 {dtype} index bytes: {json.dumps(gauges)}; compiles {svc.stats.compiles} "
            f"for bucket shapes {sorted(b[0] for b in buckets)} over "
            f"{svc.stats.batches} batches")
        # 64 queries through the plain versions: the same ids up to ties
        plain = HybridSearchService(p, SearchParams(use_keywords=True, corpus_dtype=dtype,
                                                    use_kernel=False))
        for name, spec, kw in specs[::2]:
            rp = plain.search(c.queries[0:64], spec, keywords=None if kw is None else kw[:64])
            rk = rows[name]["res"]
            ids_agree(rk.ids[:64], rk.scores[:64], rp.ids, rp.scores, TOL)
        say(f"phase 5 {dtype} plain check: 64 queries through the plain versions agree up to "
            "ties (three_path, keyword)")
        out[dtype] = dict(rows=rows, dense=gauges.get(f"dense/{dtype}", 0))
        del svc, plain
        torch.cuda.empty_cache()

    for dtype, other in (("float32", "int8"), ("int8", "float32")):
        say(f"phase 5 launches while the {dtype} pool served: {json.dumps(launches[dtype])}")
        for k in ("hybrid_distance", "fused_topk"):
            mine, theirs = (k, k + "_int8") if dtype == "float32" else (k + "_int8", k)
            need(launches[dtype][mine] > 0, f"{mine} was not launched while the {dtype} pool "
                 "served")
            need(launches[dtype][theirs] == 0, f"{theirs} launched while the {dtype} pool served")
    for k in ("hybrid_distance", "fused_topk"):  # fp32: phase 4's path plus this one
        results[k]["launches"] += launches["float32"][k]
        results[k + "_int8"]["launches"] = launches["int8"][k + "_int8"]
    ratio = out["int8"]["dense"] / out["float32"]["dense"]
    need(ratio <= 0.26, f"int8 dense bytes are {ratio:.4f} of fp32")
    gap = out["float32"]["rows"]["three_path"]["recall"] - out["int8"]["rows"]["three_path"][
        "recall"]
    need(abs(gap) <= RECALL_GAP, f"int8 three-path recall@10 differs from fp32 by {gap:.4f}")
    served = recall_at_k(out["int8"]["rows"]["three_path"]["res"].ids,
                         out["float32"]["rows"]["three_path"]["res"].ids)
    say(f"phase 5 int8 vs fp32: dense bytes ratio {ratio:.4f}; three-path recall@10 gap "
        f"{gap:.4f} (limit {RECALL_GAP}); served top-10 overlap {served:.4f}")

    # ---- int8 storage against fp32, independent of the graph ---------------
    # brute force over the rows a pool stores vs brute force over the fp32
    # corpus, three-path weights: top-10 overlap, and per (query, true top-10
    # doc) the score gap against what the format allows, half a quantization
    # step per dense term plus fp16 rounding (2^-11) of each sparse product
    # (vals are >= 0, so the sparse part of the score is their sum). Planted
    # faults must fail one of the two checks.
    spec3 = FusionSpec.three_path()
    qw3 = weighted_query(c.queries, spec3.weights)
    want = truth(spec3).long()
    need(all(bool((v >= 0).all()) for f in (c.docs, qw3) for v in (f.learned.val, f.lexical.val)),
         "negative sparse values: the fp16 bound below needs vals >= 0")
    s_fp32 = ops.hybrid_scores_vs_ids(qw3, c.docs, want.int())
    dense_part = torch.einsum("bd,bkd->bk", qw3.dense, c.docs.dense[want])
    q_l1 = qw3.dense.abs().sum(1, keepdim=True)

    def stored_vs_fp32(p):
        """(top-10 overlap, max score gap / allowed gap) of pool p's storage."""
        docs, gids, _ = alive_docs_pool(p)
        gids = torch.as_tensor(gids, dtype=torch.long, device=device)
        top = gids[ops.topk_hybrid(qw3, docs, 10, chunk=8192)[1].long()]
        at = torch.empty(n, dtype=torch.long, device=device)
        at[gids] = torch.arange(gids.numel(), device=device)
        scale = torch.empty(n, device=device)
        for g in p.groups:
            gid = g.global_ids.reshape(-1).long()
            scale[gid[gid >= 0]] = g.index.corpus.dense_scale.reshape(-1)[gid >= 0]
        s_stored = ops.hybrid_scores_vs_ids(qw3, docs, at[want].int())
        allowed = 0.5 * scale[want] * q_l1 + 2.0**-11 * (s_fp32 - dense_part).abs() + TOL
        return recall_at_k(top, want), float(((s_stored - s_fp32).abs() / allowed).max().item())

    def planted(fn):
        return SegmentPool(groups=[SegmentedIndex(dataclasses.replace(
            g.index, corpus=fn(g.index.corpus)), g.global_ids) for g in pool_q.groups])

    bf16 = lambda sv: SparseVec(sv.idx, sv.val.to(torch.bfloat16).to(torch.float16))
    faults = {
        "scale=1": lambda q: dataclasses.replace(q, dense_scale=torch.ones_like(q.dense_scale)),
        "scale x2": lambda q: dataclasses.replace(q, dense_scale=2 * q.dense_scale),
        "vals via bf16": lambda q: dataclasses.replace(q, learned=bf16(q.learned),
                                                       lexical=bf16(q.lexical)),
    }
    overlap, gap_ratio = stored_vs_fp32(pool_q)
    readings = {k: stored_vs_fp32(planted(fn)) for k, fn in faults.items()}
    say(f"phase 5 int8 vs fp32 brute force (three-path, top-10 of {n}): overlap {overlap:.4f} "
        f"(limit {INT8_OVERLAP}), max score gap {gap_ratio:.4f} of the allowed gap; planted "
        "faults: " + ", ".join(f"{k} overlap {ov:.4f} gap {r:.4g}x allowed"
                               for k, (ov, r) in readings.items()))
    need(overlap >= INT8_OVERLAP, f"int8 brute-force top-10 overlap {overlap:.4f}")
    need(gap_ratio <= 1.0, f"int8 score gap {gap_ratio:.4f} of the allowed gap")
    for k, (ov, r) in readings.items():
        need(ov < INT8_OVERLAP or r > 1.0, f"planted fault {k} passes the int8 checks")


def flash_work(q, k, v, causal: bool) -> tuple[float, float, float]:
    """(bytes, flops, peak flop rate) of one attention forward: q, k, v read
    once, out and the fp32 LSE written once; 4 d flop per (row, col) pair the
    mask keeps (QK^T and PV), counted for this shape."""
    import torch

    b, h, l, dk = q.shape
    s, dv = k.shape[2], v.shape[3]
    pairs = sum(min(r + 1, s) for r in range(l)) if causal else l * s
    esz = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + b * h * l * dv) * esz + b * h * l * 4
    flops = 2.0 * b * h * pairs * (dk + dv)
    return nbytes, flops, BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S


def phase_flash(cfg, results: dict):
    """The flash kernel against its plain version on the card: at the RAG
    prefill shape (bf16, timed beside the plain version and SDPA; fp32 on 4
    rows) and at edge shapes in fp32 and bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(13)
    results.setdefault("flash_attention_fwd", {"max_abs_err": 0.0, "checks": []})

    def qkv(b, h, kv, l, s, dk, dv, dtype):
        """Random q, k, v in the model's (B, L, H, d) memory, (B, H, L, d) views."""
        mk = lambda n, heads, d: torch.randn((b, n, heads, d), generator=gen, device="cuda",
                                             dtype=torch.float32).to(dtype).transpose(1, 2)
        return mk(l, h, dk), mk(s, kv, dk), mk(s, kv, dv)

    def check(label, q, k, v, causal, rows=None):
        """Kernel vs plain on ``rows`` batch rows (all by default)."""
        tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
        out, lse = flash_attention_fwd(q, k, v, causal)
        sl = slice(None) if rows is None else slice(0, rows)
        want_out, want_lse = flash_attention_plain(q[sl], k[sl], v[sl], causal, q.shape[-1] ** -0.5)
        torch.cuda.synchronize()
        err = 0.0
        for got, want in ((out[sl].float(), want_out.float()), (lse[sl], want_lse)):
            need(bool(torch.isfinite(got).all()), f"flash {label}: non-finite output")
            diff = (got - want).abs()
            need(bool((diff <= tol + tol * want.abs()).all()),
                 f"flash {label}: error {float(diff.max()):.3g} beyond {tol} + {tol}|x|")
            err = max(err, float(diff.max()))
        results["flash_attention_fwd"]["max_abs_err"] = max(
            results["flash_attention_fwd"]["max_abs_err"], err)
        return err

    edges = [
        # label, (B, H, KV, L, S, dk, dv), causal
        ("tail L=S=333 g=4", (2, 8, 2, 333, 333, 64, 64), True),
        ("L=S=1", (4, 8, 2, 1, 1, 64, 64), True),
        ("dk=48 dv=32", (2, 4, 2, 130, 130, 48, 32), True),
        ("non-causal L=100 S=300 g=1", (2, 4, 4, 100, 300, 64, 64), False),
        ("top-left causal L=96 S=160", (2, 8, 2, 96, 160, 64, 64), True),
    ]
    for label, shape, causal in edges:
        for dtype in (torch.float32, torch.bfloat16):
            err = check(label, *qkv(*shape, dtype), causal)
            say(f"phase 6 flash {label} {str(dtype)[6:]}: max_abs_err {err:.3g} "
                f"(tol {FLASH_TOL[str(dtype)[6:]]})")

    # the RAG prefill shape: every layer of a prefill launches this
    b, h, kv, d = RAG_REQUESTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    l = RAG_TOP_K * RAG_CTX + RAG_PROMPT
    q, k, v = qkv(b, h, kv, l, l, d, d, torch.bfloat16)
    err = check("rag", q, k, v, True, rows=8)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, True), 10)
    plain_ms = time_ms(lambda: [flash_attention_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8], True,
                                                      d**-0.5) for i in range(0, b, 8)], 2, warm=1)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    lib_out = sdpa()
    need(bool(torch.isfinite(lib_out).all()), "SDPA: non-finite output")
    library_ms = time_ms(sdpa, 10)
    nbytes, flops, rate = flash_work(q, k, v, True)
    b_ms, b_by = bound(nbytes, flops, rate)
    shape = f"rag_prefill B={b} H={h} KV={kv} L=S={l} d={d} causal bf16"
    results["flash_attention_fwd"]["checks"].append(dict(
        shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms))
    say(f"phase 6 flash {shape}: max_abs_err (8 rows) {err:.3g} ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}: {nbytes / 1e9:.3f} GB, "
        f"{flops / 1e9:.1f} GFLOP) sdpa_ms {library_ms:.4f}")
    del q, k, v, lib_out
    # the same shape in fp32 on 4 rows, where 1e-5 leaves a wrong tile loop,
    # causal skip or stride no room
    err = check("rag fp32", *qkv(4, h, kv, l, l, d, d, torch.float32), True)
    say(f"phase 6 flash rag B=4 H={h} KV={kv} L=S={l} d={d} causal float32: max_abs_err "
        f"{err:.3g} (tol {FLASH_TOL['float32']})")
    torch.cuda.empty_cache()


def planted_flash(kernel, causal: bool, drop: int):
    """A faulty stand-in for ``models.attention._flash`` that still runs the
    kernel: the causal mask off, or the last ``drop`` keys left out."""

    def flash(q, k, v):  # (B, L, H, d), as _flash takes them
        s = k.shape[1] - drop
        out, _ = kernel(q.transpose(1, 2), k[:, :s].transpose(1, 2), v[:, :s].transpose(1, 2),
                        causal)
        return out.transpose(1, 2)

    return flash


def phase_rag(corpus_bundle, index, results: dict):
    """Retrieval-augmented generation at llama3.2-1b's full width."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.fusion import FusionSpec
    from repro_torch.core.search import search
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.obs.tracer import TraceContext
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.hybrid_service import HybridSearchService
    from repro_torch.serving.rag import RagConfig, RagPipeline

    c = corpus_bundle
    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    params = tfm.init_params(cfg, gen)
    doc_tokens = torch.randint(0, cfg.vocab, (c.docs.n, RAG_CTX), generator=gen, device="cuda",
                               dtype=torch.int32)
    prompts = torch.randint(0, cfg.vocab, (RAG_REQUESTS, RAG_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say(f"phase 6 setup: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype}, "
        f"{n_params} parameters (config n_params {cfg.n_params}, without the norms); doc_tokens "
        f"{tuple(doc_tokens.shape)}; {time.perf_counter() - t:.1f} s")

    phase_flash(cfg, results)

    rag_cfg = RagConfig(top_k=RAG_TOP_K, ctx_tokens_per_doc=RAG_CTX)
    service = HybridSearchService(index, dataclasses.replace(rag_cfg.search, k=RAG_TOP_K))
    engine = ServingEngine(cfg, params, ServeConfig(max_len=RAG_MAX_LEN))
    rag = RagPipeline(engine, index, doc_tokens, rag_cfg, service=service)
    queries = c.queries[0:RAG_REQUESTS]
    rag.answer(c.queries[0:8], prompts[:8], 2)  # warm-up: library handles, allocator

    # ---- the main path: counts zeroed just before, read just after --------
    wrappers = {"flash_attention_fwd": flash_attention_fwd, "hybrid_distance": hybrid_distance,
                "fused_topk": fused_topk}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trace = TraceContext("rag")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, res = rag.answer(queries, prompts, RAG_GEN, trace=trace)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    span = lambda name: trace.find(name)[0]
    retrieval_s = span("context_assembly").t0 - t0
    prefill_s = span("prefill").t1 - span("prefill").t0
    decode_s = span("decode").t1 - span("decode").t0
    l = RAG_TOP_K * RAG_CTX + RAG_PROMPT
    say(f"phase 6 RAG {RAG_REQUESTS} requests, top-{RAG_TOP_K} x {RAG_CTX} context + "
        f"{RAG_PROMPT} prompt (L = {l}), {RAG_GEN} tokens greedy: retrieval {retrieval_s:.3f} s, "
        f"prefill {prefill_s:.3f} s ({RAG_REQUESTS * l / prefill_s:.1f} tokens/s), decode "
        f"{decode_s:.3f} s ({RAG_REQUESTS * (RAG_GEN - 1) / decode_s:.1f} tokens/s over "
        f"{RAG_GEN - 1} steps), end to end {e2e:.3f} s per batch; peak memory {peak_gb:.2f} GB")
    say(f"phase 6 main-path launches: {json.dumps(launches)} (one answer: retrieval through "
        f"the service, one prefill of {cfg.n_layers} layers)")
    need(launches["flash_attention_fwd"] == cfg.n_layers,
         f"flash launches {launches['flash_attention_fwd']} != {cfg.n_layers} per prefill")
    for k in ("hybrid_distance", "fused_topk"):
        need(launches[k] > 0, f"{k} was not launched while RAG retrieved")
        results[k]["launches"] += launches[k]
    results["flash_attention_fwd"]["launches"] = launches["flash_attention_fwd"]

    # ---- what came out ------------------------------------------------------
    full = torch.cat([rag.build_context(res), prompts], dim=1)
    need(tuple(out.shape) == (RAG_REQUESTS, l + RAG_GEN), f"output shape {tuple(out.shape)}")
    need(torch.equal(out[:, :l], full), "the output does not start with [context ; prompt]")
    need(bool(((out >= 0) & (out < cfg.vocab)).all()), "generated tokens out of range")
    need(bool((res.ids[:, :RAG_TOP_K] >= 0).all()), "a request retrieved fewer than top_k docs")
    direct = search(index, queries, FusionSpec.three_path(),
                    dataclasses.replace(rag_cfg.search, k=RAG_TOP_K), device="cuda")
    ids_agree(res.ids.cuda(), res.scores.cuda(), direct.ids, direct.scores, TOL)
    say("phase 6 retrieval: the service's top-4 agree with direct search up to ties")

    logits, _ = tfm.make_prefill(cfg, RAG_MAX_LEN)(params, full)
    need(bool(torch.isfinite(logits.float()).all()), f"non-finite prefill logits at L = {l}")
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    naive, _ = tfm.make_prefill(naive_cfg, RAG_MAX_LEN)(params, full[:8])
    gap = float((logits[:8].float() - naive.float()).abs().max())
    agree = float((logits[:8].argmax(-1) == naive.argmax(-1)).float().mean())
    say(f"phase 6 prefill logits at L = {l}: finite for all {RAG_REQUESTS} rows; flash vs naive "
        f"on 8 rows: max |diff| {gap:.4g} (limit {PREFILL_GAP}), argmax agreement {agree:.3f}")
    need(gap <= PREFILL_GAP, f"flash prefill differs from naive by {gap:.4g}")

    # planted faults in the flash path, still through the kernel: each must
    # read above the limit
    sound = attention._flash
    try:
        for label, causal, drop in (("causal mask off", False, 0),
                                    ("last key tile dropped", True, 64)):
            attention._flash = planted_flash(flash_attention_fwd, causal, drop)
            bad, _ = tfm.make_prefill(cfg, RAG_MAX_LEN)(params, full[:8])
            fgap = float((bad.float() - naive.float()).abs().max())
            fagree = float((bad.argmax(-1) == naive.argmax(-1)).float().mean())
            say(f"phase 6 planted fault {label}: flash vs naive max |diff| {fgap:.4g}, argmax "
                f"agreement {fagree:.3f}")
            need(fgap > PREFILL_GAP, f"planted fault {label} passes the prefill check")
    finally:
        attention._flash = sound
    del params, doc_tokens, service, engine, rag
    torch.cuda.empty_cache()



def bwd_work(q, k, v, causal: bool, kernel: str) -> tuple[float, float, float]:
    """(bytes, flops, peak rate) of one backward kernel: q, k, v, dO, LSE and
    Delta read once, the gradients it writes written once; 2 flop per
    multiply-add of the products over the (row, col) pairs the mask keeps:
    dQ runs QK^T, dO V^T and dS K (3 products at d = 64); dK/dV runs those
    first two, P^T dO and dS^T Q (4)."""
    import torch

    b, h, l, dk = q.shape
    s, dv = k.shape[2], v.shape[3]
    pairs = sum(min(r + 1, s) for r in range(l)) if causal else l * s
    esz = q.element_size()
    ins = (q.numel() + k.numel() + v.numel() + b * h * l * dv) * esz + 2 * b * h * l * 4
    if kernel == "dq":
        outs, width = q.numel() * esz, 2 * dk + dv
    else:
        outs, width = (k.numel() + v.numel()) * esz, 2 * dk + 2 * dv
    flops = 2.0 * b * h * pairs * width
    return ins + outs, flops, BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S


def phase_flash_bwd(cfg, results: dict):
    """The two backward kernels against the plain version on the card: at
    the training shape (bf16, timed beside the plain version and the SDPA
    backward; fp32 on 2 rows) and at edge shapes in fp32 and bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        _delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(14)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        results.setdefault(name, {"max_abs_err": 0.0, "checks": []})

    def inputs(b, h, kv, l, s, dk, dv, dtype):
        """q, k, v in the model's (B, L, H, d) memory and dO in memory of its
        own (L, B, H, dv), as (B, H, L, d) views; out and LSE from the
        forward kernel."""
        mk = lambda n, heads, d: torch.randn((b, n, heads, d), generator=gen, device="cuda",
                                             dtype=torch.float32).to(dtype).transpose(1, 2)
        q, k, v = mk(l, h, dk), mk(s, kv, dk), mk(s, kv, dv)
        do = torch.randn((l, b, h, dv), generator=gen, device="cuda").to(dtype).permute(1, 2, 0, 3)
        return q, k, v, do

    def check(label, q, k, v, do, causal, rows=None):
        """Both kernels vs the plain version on ``rows`` batch rows (all by
        default). Returns, per kernel, (max |err|, max |err| / (atol + rtol
        |w|)), the second at most 1."""
        atol, rtol = GRAD_TOL[str(q.dtype).removeprefix("torch.")]
        out, lse = flash_attention_fwd(q, k, v, causal)
        delta = _delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        sl = slice(None) if rows is None else slice(0, rows)
        want = flash_attention_bwd_plain(q[sl], k[sl], v[sl], out[sl], lse[sl], do[sl], causal,
                                         q.shape[-1] ** -0.5)
        torch.cuda.synchronize()
        worst = {}
        for name, got, w in (("flash_attention_bwd_dq", dq[sl], want[0]),
                             ("flash_attention_bwd_dkv", dk[sl], want[1]),
                             ("flash_attention_bwd_dkv", dv[sl], want[2])):
            got, w = got.float(), w.float()
            need(bool(torch.isfinite(got).all()), f"flash bwd {label}: non-finite {name}")
            diff = (got - w).abs()
            reading = float((diff / (atol + rtol * w.abs())).max())
            need(reading <= 1, f"flash bwd {label} {name}: error {float(diff.max()):.3g}, "
                 f"{reading:.3g} of its limit {atol:.3g} + {rtol:.3g} |w|")
            err, rd = worst.get(name, (0.0, 0.0))
            worst[name] = (max(err, float(diff.max())), max(rd, reading))
        for name, (err, _) in worst.items():
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        return worst

    def say_check(label, dtype, worst):
        atol, rtol = GRAD_TOL[str(dtype).removeprefix("torch.")]
        say(f"phase 7 flash bwd {label} {str(dtype)[6:]}: " + ", ".join(
            f"{n.removeprefix('flash_attention_bwd_')} max_abs_err {e:.3g} reading {r:.3g}"
            for n, (e, r) in worst.items()) + f" (of the limit {atol:.3g} + {rtol:.3g} |w|)")

    edges = [
        # label, (B, H, KV, L, S, dk, dv), causal
        ("tail L=S=333 g=4", (2, 8, 2, 333, 333, 64, 64), True),
        ("L=S=1", (4, 8, 2, 1, 1, 64, 64), True),
        ("non-causal L=100 S=300 g=1", (2, 4, 4, 100, 300, 64, 64), False),
        ("g=1 L=S=200", (2, 4, 4, 200, 200, 64, 64), True),
        ("dk=192 dv=128 L=S=130", (2, 4, 1, 130, 130, 192, 128), True),
    ]
    for label, shape, causal in edges:
        for dtype in (torch.float32, torch.bfloat16):
            say_check(label, dtype, check(label, *inputs(*shape, dtype), causal))

    # the training shape: every layer of a training step launches both kernels
    b, h, kv, d, l = TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, TRAIN_SEQ
    q, k, v, do = inputs(b, h, kv, l, l, d, d, torch.bfloat16)
    worst = check("train", q, k, v, do, True, rows=2)
    say_check(f"train B={b} (2 rows checked)", torch.bfloat16, worst)
    out, lse = flash_attention_fwd(q, k, v, True)
    delta = _delta(out, do)
    times = {"flash_attention_bwd_dq": time_ms(
        lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, True), 5),
        "flash_attention_bwd_dkv": time_ms(
        lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, True), 5)}
    plain_ms = time_ms(lambda: [flash_attention_bwd_plain(
        q[i:i + 2], k[i:i + 2], v[i:i + 2], out[i:i + 2], lse[i:i + 2], do[i:i + 2], True,
        d**-0.5) for i in range(0, b, 2)], 2, warm=1)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    lib_grads = torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True)
    need(all(bool(torch.isfinite(g).all()) for g in lib_grads), "SDPA backward: non-finite")
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                     retain_graph=True), 5)
    shape = f"train B={b} H={h} KV={kv} L=S={l} d={d} causal bf16"
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        nbytes, flops, rate = bwd_work(q, k, v, True, name.removeprefix("flash_attention_bwd_"))
        b_ms, b_by = bound(nbytes, flops, rate)
        results[name]["checks"].append(dict(
            shape=shape, ms=times[name], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms))
        say(f"phase 7 {name} {shape}: ms {times[name]:.4f} bound_ms {b_ms:.4f} ({b_by}: "
            f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP) plain_ms (dQ, dK and dV in 2-row "
            f"calls) {plain_ms:.4f} sdpa_bwd_ms (dQ, dK and dV) {library_ms:.4f}")
    del q, k, v, do, out, lse, delta, qs, ks, vs, lib_out, lib_grads
    torch.cuda.empty_cache()
    # the same shape in fp32 on 2 rows, where 2e-4 leaves a wrong tile loop,
    # causal skip, stride or head sum no room
    say_check("train B=2 fp32", torch.float32,
              check("train fp32", *inputs(2, h, kv, l, l, d, d, torch.float32), True))
    torch.cuda.empty_cache()


def planted_bwd(kind: str):
    """A stand-in for ``flash_attention_bwd`` that still runs the kernels.
    Faults: dK/dV summed over only the first query head of each group
    (``first_head``), Delta taken as 0 (``delta``), or the last key tile's
    dS dropped (``last_tile``: dQ without its share, dK zero there). Not a
    fault: Delta from O recomputed in fp32 by the plain forward instead of
    the forward's output in its own dtype (``fp32_delta``), which tells how
    much of the bf16 gradients' drift is O's rounding."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    def bwd(q, k, v, out, lse, dout, causal=True, sm_scale=None):
        delta = fa._delta(out, dout)
        if kind == "delta":
            delta = torch.zeros_like(delta)
        elif kind == "fp32_delta":
            scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
            out32, _ = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
            delta = fa._delta(out32, dout)
        dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal, sm_scale)
        if kind == "first_head":
            g = q.shape[1] // k.shape[1]
            dk, dv = fa.flash_attention_bwd_dkv(q[:, ::g], k, v, dout[:, ::g], lse[:, ::g],
                                                delta[:, ::g], causal, sm_scale)
        elif kind == "last_tile":
            s = k.shape[2] - 64
            dq = fa.flash_attention_bwd_dq(q, k[:, :, :s], v[:, :, :s], dout, lse, delta, causal,
                                           sm_scale)
            dk = dk.clone()
            dk[:, :, s:] = 0
        return dq, dk, dv

    return bwd


def loss_grads(cfg, params, tokens):
    """(names, gradients) of ``make_loss_fn(cfg)`` on ``tokens``."""
    import torch

    from repro_torch.models import transformer as tfm

    names, leaves = zip(*params.named_parameters())
    loss = tfm.make_loss_fn(cfg)(params, {"tokens": tokens})
    return names, torch.autograd.grad(loss, leaves)


def rel_gap(names, got, want) -> tuple[float, str]:
    """Max over parameters of |got - want| / |want| (Frobenius norms), and
    that parameter's name."""
    gaps = [float((g.float() - w.float()).norm() / w.float().norm().clamp(min=1e-30))
            for g, w in zip(got, want)]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[i], names[i]


def bf16_readings(cfg, params, tokens):
    """``rel_gap`` readings of the bf16 loss gradients: flash against naive,
    and flash, flash with Delta from an fp32 O (``planted_bwd("fp32_delta")``)
    and naive each against naive at fp32 copies of the same parameters.
    Turns ``params`` to float32 in place; returns (readings, parameter
    names, the fp32 naive gradients)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa

    grads, sound = {}, fa.flash_attention_bwd
    for label, impl, bwd in (("flash", "flash", sound),
                             ("flash with Delta from fp32 O", "flash", planted_bwd("fp32_delta")),
                             ("naive", "naive", sound)):
        fa.flash_attention_bwd = bwd
        try:
            names, grads[label] = loss_grads(dataclasses.replace(cfg, attn_impl=impl), params,
                                             tokens)
        finally:
            fa.flash_attention_bwd = sound
    params.float()
    naive32 = loss_grads(dataclasses.replace(cfg, dtype="float32", attn_impl="naive"), params,
                         tokens)[1]
    readings = {"bf16 flash vs bf16 naive": rel_gap(names, grads["flash"], grads["naive"])}
    readings.update({f"bf16 {k} vs fp32 naive": rel_gap(names, g, naive32)
                     for k, g in grads.items()})
    return readings, names, naive32


def grad_gap(cfg, params, tokens) -> tuple[float, str]:
    """``rel_gap`` of the loss gradients through flash against naive."""
    import dataclasses

    names, flash = loss_grads(dataclasses.replace(cfg, attn_impl="flash"), params, tokens)
    _, naive = loss_grads(dataclasses.replace(cfg, attn_impl="naive"), params, tokens)
    return rel_gap(names, flash, naive)


def phase_train(cfg, results: dict):
    """Training ``cfg`` (llama3.2-1b at full width and depth): one warm-up
    step, then the timed steps of make_train_step; then its gradients
    through flash against naive attention, with planted faults in the
    backward."""
    import dataclasses
    import math

    import torch

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, make_train_state, make_train_step

    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=10))
    t = time.perf_counter()
    state = make_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0), device="cuda")
    batches = [pipe.batch(s) for s in range(1 + TRAIN_TIMED)]
    step_fn = make_train_step(cfg, tcfg, None, None)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    say(f"phase 7 setup: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype} "
        f"remat {cfg.remat} attn {cfg.attn_impl}, {n_params} parameters, AdamW fp32 moments; "
        f"{1 + TRAIN_TIMED} batches of {TRAIN_BATCH} x {TRAIN_SEQ} tokens; "
        f"{time.perf_counter() - t:.1f} s")

    # ---- the main path: counts zeroed just before, read after every step ----
    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rows, seen = [], {k: 0 for k in wrappers}
    for s, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: w.launches - seen[k] for k, w in wrappers.items()}
        seen = {k: w.launches for k, w in wrappers.items()}
        row = dict(step=s, seconds=dt, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / dt,
                   loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   lr=float(metrics["lr"]), launches=counts)
        rows.append(row)
        say(f"phase 7 step {s}{' (warm-up)' if s == 0 else ''}: {dt:.4f} s "
            f"({row['tokens_per_s']:.1f} tokens/s) loss {row['loss']:.6f} grad_norm "
            f"{row['grad_norm']:.6f} lr {row['lr']:.6g} launches {json.dumps(counts)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(r["seconds"] for r in rows[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"phase 7 training: median step {med:.4f} s over {TRAIN_TIMED} timed steps "
        f"({tokens / med:.1f} tokens/s; {6 * n_params * tokens / med / 1e12:.1f} TFLOP/s of "
        f"6 N D), peak memory {peak_gb:.2f} GB")
    want = {"flash_attention_fwd": 2 * cfg.n_layers, "flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers}
    for r in rows:
        need(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
             f"step {r['step']}: non-finite loss or grad norm")
        need(r["launches"] == want, f"step {r['step']}: launches {r['launches']} != {want}")
    first, last = rows[0]["loss"], rows[-1]["loss"]
    need(abs(first - math.log(cfg.vocab)) <= 0.5,
         f"first loss {first:.4f} is not within 0.5 of ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}")
    need(last < first, f"the loss did not go down: {first:.4f} -> {last:.4f}")
    say(f"phase 7 checks: losses and grad norms finite; first loss {first:.4f} (ln V = "
        f"{math.log(cfg.vocab):.4f}), last {last:.4f}; every step launched "
        f"{json.dumps(rows[-1]['launches'])}")
    for k in wrappers:
        results.setdefault(k, {"launches": 0})
        results[k]["launches"] = results[k].get("launches", 0) + seen[k]

    # ---- gradients through flash against naive, on 2 rows ------------------
    params = state["params"]
    del state, batches
    torch.cuda.empty_cache()
    tokens2 = pipe.batch(0)["tokens"][:2]
    readings, names, naive32 = bf16_readings(cfg, params, tokens2)  # params now fp32: the gate
    say(f"phase 7 gradients, 2 x {TRAIN_SEQ} tokens, max over parameters of |g - g_ref| / "
        "|g_ref| (printed, not gated): " + "; ".join(f"{k} {g:.4g} ({n})"
                                                      for k, (g, n) in readings.items()))
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gap, where = rel_gap(names, loss_grads(cfg32, params, tokens2)[1], naive32)
    say(f"phase 7 gradients in fp32: flash vs naive {gap:.4g} ({where}; limit {GRAD_GAP})")
    need(gap <= GRAD_GAP, f"flash gradients differ from naive by {gap:.4g}")
    torch.cuda.empty_cache()
    sound = fa.flash_attention_bwd
    try:
        for kind in ("first_head", "delta", "last_tile"):
            fa.flash_attention_bwd = planted_bwd(kind)
            fgap, fwhere = rel_gap(names, loss_grads(cfg32, params, tokens2)[1], naive32)
            say(f"phase 7 planted fault {kind}: flash vs naive in fp32 {fgap:.4g} ({fwhere})")
            need(fgap > GRAD_GAP, f"planted fault {kind} passes the gradient check")
    finally:
        fa.flash_attention_bwd = sound
    del params, naive32
    torch.cuda.empty_cache()


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        from repro_torch.data.corpus import CorpusConfig, make_corpus

        card = phase_device()
        t = time.perf_counter()
        full = make_corpus(CorpusConfig(
            n_docs=N_FULL, n_queries=N_QUERIES, n_topics=1024, d_dense=1024, seed=0))
        torch.cuda.synchronize()
        say(f"phase 4 corpus: {N_FULL} docs x 1024 dense + 32/16 ELL, {N_QUERIES} queries "
            f"in {time.perf_counter() - t:.1f} s")
        results: dict = {}
        phase_kernels(full.docs, full.queries, results)
        phase_small_e2e()
        index = phase_full(full, results)
        torch.cuda.empty_cache()
        phase_serving(full, results)
        torch.cuda.empty_cache()
        phase_rag(full, index, results)
        del full, index
        torch.cuda.empty_cache()
        from repro_torch.configs import get_config

        train_cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="flash")
        phase_flash_bwd(train_cfg, results)
        phase_train(train_cfg, results)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    src = {
        "hybrid_distance": ("src/repro_torch/kernels/csrc/hybrid_distance.cu",
                            "src/repro/kernels/hybrid_distance.py:95", "self_scores"),
        "hybrid_distance_int8": ("src/repro_torch/kernels/csrc/hybrid_distance.cu",
                                 "src/repro/kernels/hybrid_distance.py:38", "serve_rescore"),
        "fused_topk": ("src/repro_torch/kernels/csrc/fused_topk.cu",
                       "src/repro/kernels/fused_topk.py:160", "descent_chunk"),
        "fused_topk_int8": ("src/repro_torch/kernels/csrc/fused_topk.cu",
                            "src/repro/kernels/fused_topk.py:124", "serve_round"),
        "pairwise_tile": ("src/repro_torch/kernels/csrc/pairwise_tile.cu",
                          "src/repro/kernels/pairwise_tile.py:77", "prune_chunk"),
        "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:107", "rag_prefill"),
        "flash_attention_bwd_dq": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                   "src/repro/kernels/flash_attention.py:261", "train"),
        "flash_attention_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                    "src/repro/kernels/flash_attention.py:294", "train"),
    }
    kernels = []
    for name, (path, replaces, headline) in src.items():
        r = results[name]
        chk = next(ch for ch in r["checks"] if ch["shape"].startswith(headline))
        kernels.append(dict(
            name=name, route="cuda", source=path, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=chk["ms"],
            plain_ms=chk["plain_ms"], bound_ms=chk["bound_ms"], bound_by=chk["bound_by"],
            library_ms=chk.get("library_ms"), shape=chk["shape"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
