#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

  1. device and build: the card's name and power limit, then the three CUDA
     kernels built from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
     parallel, into the gitignored ``build/`` directory);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes (Dd = 1024, the corpus caps, B x C of
     NN-Descent chunks and search rounds) plus edge cases (all-PAD rows,
     k > live, planted ties); max-abs-error, agreement up to ties, times;
  3. small end-to-end: N = 4096 docs with the KG, built and searched once
     through the kernels and once through the plain versions;
  4. full width: make_corpus at N = 2^20, d_dense = 1024, build_index with
     the default BuildConfig (no KG: the dense (E, E) entity adjacency would
     be ~1 TB), search 1024 queries under six fusion specs, QPS and recall;
  5. the kernels line: launches on the main path (phase 4), errors, times
     and bounds;
  6. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs one CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
TOL = 1e-4  # fp32 sums of ~1000 products in another order than the plain version
N_FULL = 2**20
N_QUERIES = 1024


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
    return f.dense.shape[1] * 4 + (f.learned.idx.shape[1] + f.lexical.idx.shape[1]) * 8


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    tb, tf = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def scoring_work(q, corpus, ids, out_bytes: int, extra_in: int = 0):
    """Bytes each input read once (unique live corpus rows, query rows, ids),
    output once; flops of the live (query, row) pairs' dense products."""
    import torch

    live = ids[ids >= 0]
    uniq = int(torch.unique(live).numel())
    nbytes = uniq * row_bytes(corpus) + q.n * row_bytes(q) + ids.numel() * 4 + out_bytes + extra_in
    flops = 2.0 * corpus.dense.shape[1] * int(live.numel())
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
    rescore_q = FusedVectors(torch.cat([qw.dense] * 3), SparseVec(
        torch.cat([qw.learned.idx] * 3), torch.cat([qw.learned.val] * 3)), SparseVec(
        torch.cat([qw.lexical.idx] * 3), torch.cat([qw.lexical.val] * 3)))
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
        phase_full(full, results)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    src = {
        "hybrid_distance": ("src/repro_torch/kernels/csrc/hybrid_distance.cu",
                            "src/repro/kernels/hybrid_distance.py:95", "self_scores"),
        "fused_topk": ("src/repro_torch/kernels/csrc/fused_topk.cu",
                       "src/repro/kernels/fused_topk.py:160", "descent_chunk"),
        "pairwise_tile": ("src/repro_torch/kernels/csrc/pairwise_tile.cu",
                          "src/repro/kernels/pairwise_tile.py:77", "prune_chunk"),
    }
    kernels = []
    for name, (path, replaces, headline) in src.items():
        r = results[name]
        chk = next(ch for ch in r["checks"] if ch["shape"].startswith(headline))
        kernels.append(dict(
            name=name, route="cuda", source=path, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=chk["ms"],
            plain_ms=chk["plain_ms"], bound_ms=chk["bound_ms"], bound_by=chk["bound_by"],
            library_ms=None, shape=chk["shape"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
