"""Segment sealing: back-to-back ``build_pool_segment`` builds in int8.

What a segment pool does as data streams in and whenever it compacts: build
a slice of docs into a sealed segment and store its corpus in the int8 seal
format. Set-up makes the corpus from the seed and builds one slice to warm
up; the window then builds slice after slice, cycling over the first
``slices`` slices of ``segment_docs``; a build that starts in the window
runs to its end. After the window each sealed segment answers the same
``check_queries`` queries, for recall.

The corpus is the configuration's ``n_docs``. Parameters: ``check_queries``
(the queries made), ``segment_docs``, ``slices``, ``knn_sample`` (nodes
whose kNN lists are held against brute force in a traced run), ``search``
(``SearchParams`` fields of the check's search) and ``spec`` (its fusion
spec).
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

from portbench import judge, program
from portbench import reference as ref
from portbench import trace as tr
from portbench.corpus import corpus_spec, make_corpus

STAGES = ("descent", "refinement", "prune", "entry_points", "logical_edges")


@dataclasses.dataclass
class State:
    corpus: object
    docs: object  # the program's view of the corpus rows
    segments: list = dataclasses.field(default_factory=list)  # (slice, segment)
    reports: list = dataclasses.field(default_factory=list)


def _slice(ctx, i: int) -> tuple[int, int]:
    n = int(ctx.params["segment_docs"])
    s = i % int(ctx.params["slices"])
    return s * n, (s + 1) * n


def _generator(ctx, i: int) -> torch.Generator:
    return torch.Generator(device=ctx.device).manual_seed((ctx.seed * 7919 + i) % 2**63)


def _build(state: State, ctx, i: int, report: dict | None = None):
    sp = importlib.import_module("repro_torch.core.segment_pool")
    from repro_torch.core.index import BuildConfig

    lo, hi = _slice(ctx, i)
    if report is None:
        seg = sp.build_pool_segment(state.docs[lo:hi], np.arange(lo, hi), BuildConfig(),
                                    generator=_generator(ctx, i), corpus_dtype="int8",
                                    device=ctx.device)
    else:  # the build's own stage clock, through the call it makes
        orig = sp.build_index
        sp.build_index = lambda *a, **kw: orig(*a, report=report, **kw)
        try:
            seg = sp.build_pool_segment(state.docs[lo:hi], np.arange(lo, hi), BuildConfig(),
                                        generator=_generator(ctx, i), corpus_dtype="int8",
                                        device=ctx.device)
        finally:
            sp.build_index = orig
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return seg


def setup(ctx) -> State:
    p = ctx.params
    spec = corpus_spec(ctx.config, n_queries=int(p["check_queries"]))
    corpus = make_corpus(spec, ctx.seed, ctx.device)
    state = State(corpus, program.fused(corpus.docs))
    _build(state, ctx, -1)  # the warm-up: a build of the window's shapes
    return state


def _stage_spans(t0: float, report: dict, t_end: float) -> list:
    spans, t = [], t0
    for name in STAGES:
        if name in report.get("stage_seconds", {}):
            d = report["stage_seconds"][name]
            spans.append((f"build.{name}", t, t + d, {}))
            t += d
    spans.append(("seal (pad, quantize)", t, t_end, {}))
    return spans


def window(state: State, ctx, seconds: float) -> dict:
    from repro_torch.kernels import ops

    rec = ctx.record
    i = 0
    docs = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        lo, hi = _slice(ctx, i)
        if rec is None:
            seg = _build(state, ctx, i)
        else:
            report: dict = {}
            if i == 1:  # one whole build under the device trace
                with tr.device_slice(rec, "device"), \
                        tr.catch_calls(rec, ops, "pairwise_tile_scores_vs_ids",
                                       program.tile_work):
                    a = time.perf_counter()
                    seg = _build(state, ctx, i, report)
                    b = time.perf_counter()
            else:
                a = time.perf_counter()
                seg = _build(state, ctx, i, report)
                b = time.perf_counter()
            spans = _stage_spans(a, report, b)
            rec.spans += spans
            if i == 1:
                tr.label_by_spans(rec.slices["device"], spans)
            state.reports.append(report)
        state.segments.append(((lo, hi), seg))
        docs += hi - lo
        i += 1
    elapsed = time.perf_counter() - t0
    return {"attempted": i, "failed": 0, "values": {"build_docs_per_s": docs / elapsed}}


def check(state: State, ctx) -> tuple[dict, dict]:
    from repro_torch.core.search import SearchParams, search

    p = ctx.params
    corpus = state.corpus
    queries = program.fused(corpus.queries)
    spec = program.fusion_spec(p["spec"])
    params = SearchParams(**p.get("search", {}))
    checks: dict = {}
    found = total = 0
    truths: dict = {}
    rec = ctx.record
    if rec is not None and state.reports:  # the kNN graph of the last traced build
        (lo, hi), _ = state.segments[len(state.reports) - 1]
        sub = corpus.docs.rows(slice(lo, hi))
        g = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        sample = torch.randperm(hi - lo, generator=g, device=ctx.device)[:int(p["knn_sample"])]
        rec.values["knn.recall_at_32"] = ref.knn_recall(state.reports[-1]["knn_ids"], sub,
                                                         sample, 32)
        rec.values["build.stage_seconds"] = [r["stage_seconds"] for r in state.reports]
        state.reports = []
    for (lo, hi), seg in state.segments:
        with program.kept_topk() as kept:
            res = search(seg.segment(0), queries, spec, params, device=ctx.device)
        local = program.host(res.ids)
        gids = program.host(seg.global_ids[0])
        answers = {"ids": np.where(local >= 0, gids[np.clip(local, 0, None)] - lo, -1),
                   "scores": program.host(res.scores), "path_scores": program.host(res.path_scores),
                   "expanded": program.host(res.expanded)}
        leaves = program.segment_leaves(seg)
        del res
        sub = dataclasses.replace(corpus, docs=corpus.docs.rows(slice(lo, hi)))
        want = ref.store_int8(sub.docs)
        if ctx.control is not None:
            low = ref.STORES[ctx.control](sub.docs)
            leaves.update(dense_q=low.dense, dense_scale=low.scale, self_ip=ref.self_scores(low),
                          learned_val=low.learned_val, lexical_val=low.lexical_val)
        seg_checks = ref.check_segment(leaves, sub.docs, np.arange(lo, hi), want)
        alive = torch.ones(hi - lo, dtype=torch.bool, device=sub.docs.dense.device)
        rows = ref.fusion_rows([p["spec"]], np.zeros(queries.n, int), np.arange(queries.n))
        if (lo, hi) not in truths:
            truths[(lo, hi)] = judge.truth(sub, rows, alive, ctx.config)
        ans_checks, judged, want = judge.check(sub, rows, answers, alive, ctx.config,
                                               ctx.control, truths[(lo, hi)])
        ans_checks.update(judge.check_rounds(sub, [(p["spec"]["weights"], kept)], ctx.config,
                                             ctx.control))
        del kept
        for k, v in list(seg_checks.items()) + list(ans_checks.items()):
            checks[k] = max(checks.get(k, v), v)
        h, t = judge.hits(np.asarray(judged["ids"]), want.cpu().numpy())
        found, total = found + h, total + t
    return checks, {"recall_at_10": found / max(total, 1)}
