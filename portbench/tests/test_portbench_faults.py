"""Each fault a cell can have, planted under the timed path, turns
``correct`` false; the sound run of the same cell is correct.

The runs skip the harness's look for a card and run on the CPU at a tiny
size. Faults: a step that returns its state unchanged (the search rounds
skipped; a seal that never writes the int8 rows), half of the batch left out
(half the answers, half the nodes' edges, or half of each round's top k
dropped) and an answer altered where it is produced (an id, a self score, a
round's top-k positions). The cells
run on one chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

import dataclasses
import importlib

import pytest
import torch

from portbench.tests.conftest import SEED


def _skip_rounds(monkeypatch):
    search = importlib.import_module("repro_torch.core.search")

    orig = search._search_batch
    monkeypatch.setattr(search, "_search_batch",
                        lambda *a: orig(*a[:6], dataclasses.replace(a[6], iters=0), *a[7:]))


def _half_answers(monkeypatch):
    search = importlib.import_module("repro_torch.core.search")

    orig = search.search_padded

    def half(*a, **kw):
        res = orig(*a, **kw)
        b = res.ids.shape[0]
        res.ids[b // 2:] = -1
        return res

    monkeypatch.setattr(search, "search_padded", half)


def _altered_id(monkeypatch):
    search = importlib.import_module("repro_torch.core.search")

    orig = search.search_padded

    def altered(*a, **kw):
        res = orig(*a, **kw)
        res.ids[:, 0] = torch.where(res.ids[:, 0] > 0, res.ids[:, 0] - 1, res.ids[:, 0])
        return res

    monkeypatch.setattr(search, "search_padded", altered)


def _unwritten_seal(monkeypatch):
    sp = importlib.import_module("repro_torch.core.segment_pool")

    orig = sp.quantize_corpus

    def unwritten(f):
        q = orig(f)
        return dataclasses.replace(q, dense_q=torch.zeros_like(q.dense_q),
                                   dense_scale=torch.ones_like(q.dense_scale))

    monkeypatch.setattr(sp, "quantize_corpus", unwritten)


def _half_nodes(monkeypatch):
    sp = importlib.import_module("repro_torch.core.segment_pool")

    orig = sp.build_index

    def half(*a, **kw):
        idx = orig(*a, **kw)
        sem = idx.semantic_edges.clone()
        sem[sem.shape[0] // 2:] = -1
        return dataclasses.replace(idx, semantic_edges=sem)

    monkeypatch.setattr(sp, "build_index", half)


def _altered_self_score(monkeypatch):
    sp = importlib.import_module("repro_torch.core.segment_pool")

    orig = sp.build_index

    def altered(*a, **kw):
        idx = orig(*a, **kw)
        sip = idx.self_ip.clone()
        sip[0] *= 1.01
        return dataclasses.replace(idx, self_ip=sip)

    monkeypatch.setattr(sp, "build_index", altered)


def _topk_keeps_half(monkeypatch):
    ops = importlib.import_module("repro_torch.kernels.ops")

    orig = ops.fused_topk_vs_ids

    def half(q, corpus, ids, k, **kw):
        scores, pos = orig(q, corpus, ids, k, **kw)
        cut = (k + 1) // 2
        scores, pos = scores.clone(), pos.clone()
        scores[:, cut:], pos[:, cut:] = float("-inf"), -1
        return scores, pos

    monkeypatch.setattr(ops, "fused_topk_vs_ids", half)


def _topk_shifted(monkeypatch):
    ops = importlib.import_module("repro_torch.kernels.ops")

    orig = ops.fused_topk_vs_ids

    def shifted(q, corpus, ids, k, **kw):
        scores, pos = orig(q, corpus, ids, k, **kw)
        return scores, torch.where(pos >= 0, (pos + 1) % ids.shape[1], pos)

    monkeypatch.setattr(ops, "fused_topk_vs_ids", shifted)


FAULTS = [
    ("nq.batch-search", None),
    ("nq.batch-search", _skip_rounds),
    ("nq.batch-search", _half_answers),
    ("nq.batch-search", _altered_id),
    ("msmarco.seal", None),
    ("msmarco.seal", _unwritten_seal),
    ("msmarco.seal", _half_nodes),
    ("msmarco.seal", _altered_self_score),
    ("nq.batch-search", _topk_keeps_half),
    ("nq.batch-search", _topk_shifted),
    ("msmarco.seal", _topk_keeps_half),
    ("msmarco.seal", _topk_shifted),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_') if f else 'sound'}" for c, f in FAULTS])
def test_fault_turns_correct_false(tiny, monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    res = tiny.run_cell(cell, SEED, 1.0, False, device="cpu")
    failing = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    if fault is None:
        assert res["correct"] is True, res["checks"]
    else:
        assert res["correct"] is False and failing, res["checks"]
