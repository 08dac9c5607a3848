"""Rule-based entity extraction + co-occurrence knowledge-graph triplets.
Port of ``repro/ingest/entities.py`` (host numpy, as there).

The paper builds its KG offline with LLMs (§3.4); HMGI (arXiv:2510.10123)
makes the case that the entity/relational side should be extracted and
indexed *alongside* the vectors. Offline and dependency-free, the classic
rule stack still recovers most named entities in clean prose:

  * capitalized spans — maximal runs of Capitalized/ACRONYM tokens, with
    single sentence-initial capitalized words discarded (sentence case, not
    a name) unless the same surface form also appears mid-sentence;
  * an optional gazetteer (exact surface-form dictionary) that always wins.

Entity *ids* are dictionary-coded corpus-wide (top ``max_entities`` by
frequency) rather than hashed: ``core.logical_edges.build_logical_edges`` holds a
dense (E, E) adjacency, so E must stay small and known. The id table is
frozen at fit time — streamed documents only match known entities (the
frozen-stats contract; unseen names are dropped until the next refit).

Triplets are doc-level co-occurrence: entities appearing together in ≥
``min_cooc`` documents get a symmetric ``(e1, REL_COOCCURS, e2)`` edge —
exactly the ``KnowledgeGraph``-compatible (s, r, t) rows ``build_index``
feeds to ``build_logical_edges``.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.usms import PAD_IDX

REL_COOCCURS = 0

_SENT_SPLIT = re.compile(r"[.!?]+\s+|\n+")
_WORD_RE = re.compile(r"[A-Za-z][A-Za-z']*")
# sentence-case function words glue onto name runs ("In October 1520
# Magellan", "The Endeavour") — strip them from the front of a run so the
# surface form matches its mid-sentence spelling
_LEADING_SKIP = frozenset(
    """the a an in on at by of for from into onto after before during with
    within without when where while as and but or nor so yet both
    either""".split()
)


def _is_cap(tok: str) -> bool:
    return (tok[0].isupper() and tok[1:].islower() and len(tok) > 1) or (
        tok.isupper() and len(tok) >= 2
    )


def extract_entity_spans(
    text: str, *, gazetteer: Optional[Sequence[str]] = None, max_span: int = 3
) -> list[str]:
    """Entity surface forms in ``text`` (duplicates preserved — callers
    count them). Spans are runs of capitalized tokens up to ``max_span``
    long; a lone sentence-initial capitalized word only counts if the same
    form shows up mid-sentence somewhere in the document."""
    gaz = set(gazetteer) if gazetteer else set()
    spans: list[str] = []
    initial_singles: list[str] = []
    seen_mid: set[str] = set()
    for sent in _SENT_SPLIT.split(text):
        toks = _WORD_RE.findall(sent)
        run: list[str] = []
        run_start = 0
        for pos, tok in enumerate(toks):
            if _is_cap(tok):
                if not run:
                    run_start = pos
                run.append(tok)
                continue
            if run:
                _flush(run, run_start, max_span, spans, initial_singles, seen_mid)
                run = []
        if run:
            _flush(run, run_start, max_span, spans, initial_singles, seen_mid)
    # sentence-initial singles count only with mid-sentence corroboration
    spans.extend(s for s in initial_singles if s in seen_mid or s in gaz)
    if gaz:
        for name in gaz:
            # word-bounded so "Rome" never fires inside "Romeo"
            hits = len(re.findall(rf"\b{re.escape(name)}\b", text))
            already = spans.count(name)
            if hits > already:
                spans.extend([name] * (hits - already))
    return spans


def _flush(run, run_start, max_span, spans, initial_singles, seen_mid):
    while run and run[0].lower() in _LEADING_SKIP:
        run = run[1:]
        run_start += 1
    if not run:
        return
    span = " ".join(run[:max_span])
    if len(run) == 1 and run_start == 0:
        initial_singles.append(span)
    else:
        spans.append(span)
        if run_start > 0:
            seen_mid.update(run[:max_span])
            seen_mid.add(span)


@dataclasses.dataclass
class EntityVocab:
    """Frozen surface-form -> id table (id order = frequency rank)."""

    names: list[str]

    def __post_init__(self):
        self._ids = {n: i for i, n in enumerate(self.names)}

    def __len__(self) -> int:
        return len(self.names)

    def lookup(self, name: str) -> int:
        return self._ids.get(name, PAD_IDX)

    @classmethod
    def build(cls, counts: Counter, max_entities: int, min_count: int = 1):
        kept = [
            name
            for name, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            if c >= min_count
        ][:max_entities]
        return cls(names=kept)


def doc_entity_ids(
    spans_per_doc: list[list[str]], vocab: EntityVocab, entities_per_doc: int
) -> np.ndarray:
    """(N, entities_per_doc) int32, PAD-padded: each doc's most frequent
    known entities, unique per row."""
    n = len(spans_per_doc)
    out = np.full((n, max(entities_per_doc, 1)), PAD_IDX, np.int32)
    for d, spans in enumerate(spans_per_doc):
        counts = Counter(
            e for e in (vocab.lookup(s) for s in spans) if e != PAD_IDX
        )
        for c, (e, _) in enumerate(
            sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:entities_per_doc]
        ):
            out[d, c] = e
    return out


def cooccurrence_triplets(
    doc_entities: np.ndarray, n_entities: int, min_cooc: int = 2
) -> np.ndarray:
    """(T, 3) int32 (src, REL_COOCCURS, dst) rows for entity pairs sharing
    ≥ ``min_cooc`` documents. One direction per pair — ``logical_edges``
    materializes both traversal directions itself."""
    pair_counts: Counter = Counter()
    for row in doc_entities:
        ents = sorted(int(e) for e in row if e >= 0)
        for i, a in enumerate(ents):
            for b in ents[i + 1:]:
                pair_counts[(a, b)] += 1
    trips = [
        (a, REL_COOCCURS, b)
        for (a, b), c in sorted(pair_counts.items())
        if c >= min_cooc and a < n_entities and b < n_entities
    ]
    if not trips:
        return np.zeros((0, 3), np.int32)
    return np.asarray(trips, np.int32)
