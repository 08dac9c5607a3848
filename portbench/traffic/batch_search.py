"""Batch search: a closed loop of whole query sets through ``core.search``.

Users submit a whole query set at a time (batch retrieval for RAG,
evaluation runs). Set-up makes the configuration's corpus from the seed and
builds one index over it; the window searches all the queries in one call,
call after call, each call under the next fusion spec of the cell's table.

Parameters (``traffic`` in the cell's file): ``specs``, the table of fusion
specs (weighted sums only: a bare index resolves no zscore stats);
``search``, ``SearchParams`` fields; ``check_calls``, the calls per spec
whose answers and top-k selections are checked, drawn from the seed among
the spec's first ``check_span`` calls (the window runs until each has run).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from portbench import judge, program
from portbench import reference as ref
from portbench import trace as tr
from portbench.corpus import corpus_spec, make_corpus


@dataclasses.dataclass
class State:
    corpus: object
    index: object
    queries: object
    specs: list
    params: object
    checked: set = dataclasses.field(default_factory=set)  # calls the check holds
    alive: torch.Tensor = None
    calls: list = dataclasses.field(default_factory=list)  # (call, spec, ids, scores, ps, expanded)
    topk: dict = dataclasses.field(default_factory=dict)  # call -> its kept top-k selections


def setup(ctx) -> State:
    from repro_torch.core.build_pipeline import build_index
    from repro_torch.core.index import BuildConfig
    from repro_torch.core.search import SearchParams, search

    p = ctx.params
    if any(s["mode"] != "weighted_sum" for s in p["specs"]):
        raise ValueError("batch search takes weighted-sum specs only")
    corpus = make_corpus(corpus_spec(ctx.config), ctx.seed, ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    index = build_index(program.fused(corpus.docs), BuildConfig(), generator=gen,
                        device=ctx.device)
    queries = program.fused(corpus.queries)
    specs = [program.fusion_spec(s) for s in p["specs"]]
    params = SearchParams(**p.get("search", {}))
    for spec in specs:  # every call shape and spec once
        search(index, queries, spec, params, device=ctx.device).ids.cpu()
    return State(corpus, index, queries, specs, params, _checked(ctx, len(specs)))


def _checked(ctx, n_specs: int) -> set:
    """For each spec, ``check_calls`` of its first ``check_span`` calls,
    drawn from the seed."""
    p = ctx.params
    rng = np.random.default_rng(ctx.seed)
    span = int(p.get("check_span", 1))
    return {int(j) * n_specs + s for s in range(n_specs)
            for j in rng.choice(span, int(p.get("check_calls", 1)), replace=False)}


def _call(state: State, ctx, i: int):
    from repro_torch.core.search import search

    s = i % len(state.specs)
    keep = program.kept_topk() if i in state.checked else contextlib.nullcontext()
    with keep as kept:
        res = search(state.index, state.queries, state.specs[s], state.params, device=ctx.device)
    if kept is not None:
        state.topk[i] = kept
    out = (i, s, res.ids.cpu().numpy(), res.scores.cpu().numpy(),
           res.path_scores.cpu().numpy(), res.expanded.cpu().numpy())
    return out, out[5]


def traced(record, body):
    """Run ``body`` under a device trace with the scoring calls caught."""
    from repro_torch.kernels import ops

    with tr.device_slice(record, "device"), \
            tr.catch_calls(record, ops, "fused_topk_vs_ids", program.scoring_work("fused_topk")), \
            tr.catch_calls(record, ops, "hybrid_scores_vs_ids",
                           program.scoring_work("hybrid_distance")):
        body()


def window(state: State, ctx, seconds: float) -> dict:
    rec = ctx.record
    n_q = state.queries.n
    expanded, batch_s = [], []
    last = max(state.checked)
    i = 0
    t0 = time.perf_counter()
    while True:
        if rec is not None and i == 2:
            traced(rec, lambda: state.calls.append(_call(state, ctx, i)[0]))
            i += 1
            with tr.labelled_slice(rec, "labelled"):
                state.calls.append(_call(state, ctx, i)[0])
            i += 1
            continue
        a = time.perf_counter()
        out, exp = _call(state, ctx, i)
        b = time.perf_counter()
        state.calls.append(out)
        batch_s.append(b - a)
        expanded.append(float(exp.mean()))
        i += 1
        if b - t0 >= seconds and i > last:
            break
    elapsed = time.perf_counter() - t0
    if rec is not None:
        rec.values["search.batch_ms"] = [1e3 * s for s in batch_s]
        rec.values["search.expanded_per_query"] = expanded
    state.alive = state.index.alive.clone()
    live = int(state.alive.sum())
    nbytes = program.index_bytes(program.hybrid_index_tensors(state.index))
    values = {"qps": i * n_q / elapsed, "index_bytes_per_doc": nbytes / live}
    return {"attempted": i * n_q, "failed": 0, "values": values}


def check(state: State, ctx) -> tuple[dict, dict]:
    p = ctx.params
    alive = state.alive
    state.index = None  # the program's state goes before the reference runs
    n_q, n_s = state.queries.n, len(p["specs"])
    picked = [c for c in state.calls if c[0] in state.checked]
    all_rows = ref.fusion_rows(p["specs"], np.repeat(np.arange(n_s), n_q),
                               np.tile(np.arange(n_q), n_s))
    want = judge.truth(state.corpus, all_rows, alive, ctx.config)
    spec_of = np.concatenate([np.full(n_q, c[1]) for c in picked])
    query = np.concatenate([np.arange(n_q)] * len(picked))
    rows = ref.fusion_rows(p["specs"], spec_of, query)
    answers = {"ids": np.concatenate([c[2] for c in picked]),
               "scores": np.concatenate([c[3] for c in picked]),
               "path_scores": np.concatenate([c[4] for c in picked]),
               "expanded": np.concatenate([c[5] for c in picked])}
    sel = torch.as_tensor(spec_of * n_q + query, device=want.device).long()
    checks, _, _ = judge.check(state.corpus, rows, answers, alive, ctx.config, ctx.control,
                               want[sel])
    rounds = [(p["specs"][i % n_s]["weights"], kept) for i, kept in state.topk.items()]
    checks.update(judge.check_rounds(state.corpus, rounds, ctx.config, ctx.control))

    # recall over every call of the window, against each spec's exact answers
    want = want.cpu().numpy()
    found = total = 0
    for _, s, ids, *_ in state.calls:
        h, t = judge.hits(ids, want[s * n_q:(s + 1) * n_q])
        found, total = found + h, total + t
    return checks, {"recall_at_10": found / max(total, 1)}
