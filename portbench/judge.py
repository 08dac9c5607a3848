"""Judging search answers: the checks of every sampled answer, and the
reference's exact answers for recall, shared by the search traffic kinds.

The checks recompute each returned id's scores from the storage the
configuration states (fp32 rows, or the int8 seal format as the reference
works it out). The truth ranks the benchmark's fp32 rows, the users' data,
whatever the index stores. Under a control, the reference's own brute force
on the next precision down stands in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference as ref


def vocab(config: dict) -> tuple:
    return int(config["vocab_sparse"]), int(config["vocab_lexical"])


def served_stats(corpus, rows: ref.FusionRows, alive: torch.Tensor, config: dict):
    """The zscore stats of the stored corpus, where a row needs them."""
    if "zscore" not in rows.mode:
        return None
    return ref.path_stats(ref.STORES[config["storage"]](corpus.docs), alive)


def check(corpus, rows: ref.FusionRows, answers: dict, alive: torch.Tensor, config: dict,
          control: str | None = None, want: torch.Tensor | None = None,
          k: int = 10) -> tuple[dict, dict, torch.Tensor]:
    """The checks of ``answers`` (``ids``, ``scores``, ``path_scores``,
    ``expanded``, one row per fusion row); under ``control``, of the
    reference's answers in that precision instead. ``want``, the rows' exact
    answers, is worked out where not given. Returns (checks, the answers
    judged, the exact answers)."""
    if want is None:
        want = truth(corpus, rows, alive, config, k)
    served = ref.STORES[config["storage"]](corpus.docs)
    stats = served_stats(corpus, rows, alive, config)
    if control is not None:
        low = ref.STORES[control](corpus.docs)
        low_stats = ref.path_stats(low, alive) if stats is not None else None
        ids, fused, ps = ref.brute_answers(corpus.queries, low, alive, rows, vocab(config), k,
                                           low_stats)
        answers = {"ids": ids, "scores": fused, "path_scores": ps,
                   "expanded": np.full(len(ids), low.n)}  # brute force reads every doc
    checks = ref.check_answers(answers, rows, corpus.queries, served, alive, stats, want)
    return checks, answers, want


def check_rounds(corpus, rounds: list, config: dict, control: str | None = None) -> dict:
    """The checks of the search rounds' fused top-k selections: ``rounds``
    holds (fusion weights, the calls ``program.kept_topk`` kept) for each
    checked search, its queries the corpus's queries in order. Under
    ``control``, the reference's selection on that store stands in."""
    served = ref.STORES[config["storage"]](corpus.docs)
    low = ref.STORES[control](corpus.docs) if control is not None else None
    out = dict(topk_gap=0.0, topk_faults=0)
    for weights, calls in rounds:
        got = ref.check_topk(calls, corpus.queries, served, np.asarray(weights, np.float64), low)
        out = {k: max(out[k], got[k]) if k == "topk_gap" else out[k] + got[k] for k in out}
    return out


def truth(corpus, rows: ref.FusionRows, alive: torch.Tensor, config: dict, k: int = 10):
    """Each fusion row's exact top-k ids over the fp32 rows, (R, k) on the
    device."""
    stats = served_stats(corpus, rows, alive, config)
    return ref.exact_topk(corpus.queries, ref.store_fp32(corpus.docs), alive, rows,
                          vocab(config), k, stats)


def hits(got: np.ndarray, want: np.ndarray) -> tuple[int, int]:
    """(ids of ``want`` found in the same row of ``got``, ids of ``want``)."""
    live = want >= 0
    found = (got[:, :, None] == want[:, None, :]).any(1) & live
    return int(found.sum()), int(live.sum())
