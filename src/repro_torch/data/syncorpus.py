"""Synthetic corpus generator for million-doc scale runs. The port's own
copy of ``repro/data/syncorpus.py`` (numpy only): the same strings and
fields for the same seed and document index.

The bundled 120-paragraph corpus (``data/textcorpus.py``) is a quality
asset; this module is the *quantity* asset: domain-templated English-like
documents at 100k–1M scale, generated deterministically from a seed and
streamed in batches so the raw corpus never materializes in host memory.
The output feeds ``repro_torch.ingest.IngestPipeline`` unchanged — the
documents carry exactly the structure the analyzer stack extracts:

  * **topic clusters** — every document belongs to one of ``n_topics``
    topics; topics own pools of distinctive pseudo-terms (shared by their
    documents, rare elsewhere), so BM25/TF-IDF vectors cluster by topic the
    way real corpora do;
  * **seeded entity pools** — a global pool of multi-word capitalized
    entity names ("Venari Solari Institute") with topic affinity: documents
    mention entities of their own topic mid-sentence, so the rule-based
    extractor recovers them and co-occurrence triplets cluster;
  * **domain templates** — each topic belongs to a domain (research,
    markets, expedition, engineering, chronicle) whose sentence templates
    give documents realistic token-length and stopword distributions.

Determinism contract (held against repro's by
``tests/test_torch_syncorpus.py``): document i is a pure function of
``(config.seed, i)`` — the SAME document regardless of batch size,
iteration order, or how many other documents were generated.
That is what makes a streamed 1M-doc bench reproducible and lets replicas
of a sharded build re-derive any shard independently.

    gen = SynCorpus(SynCorpusConfig(n_docs=100_000, seed=7))
    pipe = IngestPipeline()
    pipe.fit(gen.fit_sample(2048))          # frozen stats from a sample
    for batch in gen.doc_batches(4096):     # stream; O(batch) memory
        docs, ents = pipe.encode_docs([d.text for d in batch])
        ...
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Domain templates. Slots: {term} topic pseudo-term, {entity} capitalized
# entity name, {noun}/{verb} domain vocabulary, {year}/{qty} numerals.
# Entity slots sit mid-sentence so the capitalized-span extractor keeps them.
# ---------------------------------------------------------------------------

_DOMAINS = (
    (
        "research",
        (
            "A recent survey of {term} methods by {entity} reported a {qty} "
            "percent improvement over the {year} baseline.",
            "The study measured {term} and {term2} under controlled load, "
            "and researchers at {entity} replicated the result.",
            "According to {entity}, the {term} hypothesis explains the "
            "observed {noun} without extra parameters.",
            "Follow-up work on {term} {verb} the earlier findings about "
            "{noun} published in {year}.",
        ),
        ("dataset", "protocol", "anomaly", "benchmark", "cohort"),
        ("confirmed", "contradicted", "extended", "reproduced"),
    ),
    (
        "markets",
        (
            "Quarterly {term} volumes rose {qty} percent after {entity} "
            "revised its {noun} guidance.",
            "Analysts at {entity} flagged {term} exposure as the main "
            "driver of the {year} {noun}.",
            "The {term} index {verb} while {entity} held its position in "
            "{term2} futures.",
            "Trading desks priced the {term} spread against a {qty} basis "
            "point move in {noun}.",
        ),
        ("forecast", "portfolio", "selloff", "dividend", "ledger"),
        ("rallied", "slipped", "stabilized", "diverged"),
    ),
    (
        "expedition",
        (
            "The expedition charted the {term} basin before a storm forced "
            "{entity} to winter at the {noun}.",
            "Guides from {entity} crossed the {term} pass in {year}, "
            "mapping {qty} kilometres of {term2} terrain.",
            "Supply caches of {noun} along the {term} route {verb} the "
            "survey team led by {entity}.",
            "Field notes describe {term} currents near the {noun} first "
            "recorded by {entity}.",
        ),
        ("glacier", "delta", "plateau", "moraine", "headland"),
        ("sustained", "delayed", "rescued", "rerouted"),
    ),
    (
        "engineering",
        (
            "The {term} controller shipped by {entity} cut {noun} latency "
            "by {qty} percent.",
            "Engineers at {entity} traced the {term} fault to a {term2} "
            "regression introduced in {year}.",
            "Load tests of the {term} pipeline {verb} under {qty} "
            "concurrent {noun} streams.",
            "A redesign of the {term} bus let {entity} retire the legacy "
            "{noun} interlock.",
        ),
        ("turbine", "firmware", "gearbox", "actuator", "manifold"),
        ("throttled", "saturated", "recovered", "degraded"),
    ),
    (
        "chronicle",
        (
            "Archives kept by {entity} date the {term} charter to {year}, "
            "decades before the {noun} was built.",
            "The {term} treaty {verb} after envoys from {entity} disputed "
            "the {term2} border.",
            "A ledger of {qty} {noun} entries records how {entity} "
            "administered the {term} district.",
            "Chroniclers credit {entity} with restoring the {term} "
            "aqueduct described in the {noun}.",
        ),
        ("dynasty", "garrison", "archive", "guildhall", "province"),
        ("collapsed", "endured", "unified", "fractured"),
    ),
)

_SYLLABLES = (
    "ka", "ri", "vo", "ta", "len", "mor", "sul", "dra", "fen", "gal",
    "hu", "bel", "nor", "pra", "qui", "ros", "tev", "ul", "wis", "zan",
    "cor", "dim", "eru", "fal", "gos", "hil", "jor", "kel", "lum", "mav",
)

_ENTITY_SUFFIX = (
    "Institute", "Holdings", "Expedition", "Works", "Archive",
    "Laboratory", "Exchange", "Survey", "Foundry", "Council",
)


def _pseudo_word(rng: np.random.Generator, n_syll: int) -> str:
    picks = rng.integers(0, len(_SYLLABLES), size=n_syll)
    return "".join(_SYLLABLES[int(p)] for p in picks)


@dataclasses.dataclass(frozen=True)
class SynCorpusConfig:
    n_docs: int = 100_000
    n_topics: int = 128
    n_entities: int = 384  # keep <= IngestConfig.max_entities
    terms_per_topic: int = 12
    entities_per_doc: int = 3
    min_sentences: int = 3
    max_sentences: int = 6
    n_queries: int = 256
    seed: int = 0

    def __post_init__(self):
        if self.n_topics < 1 or self.n_entities < self.n_topics:
            raise ValueError("need n_entities >= n_topics >= 1")


@dataclasses.dataclass
class SynDoc:
    doc_id: int
    text: str  # "<title>. <sentences>"
    topic: int
    entities: tuple[str, ...]  # surface forms mentioned mid-sentence


@dataclasses.dataclass
class SynQuery:
    text: str
    topic: int


class SynCorpus:
    """Deterministic streamed corpus: O(n_topics + n_entities) resident
    state, every document derived on demand from ``(seed, doc_id)``."""

    def __init__(self, config: Optional[SynCorpusConfig] = None):
        self.config = config or SynCorpusConfig()
        cfg = self.config
        rng = np.random.default_rng([cfg.seed, 0x5EED])
        # topic pseudo-term pools (distinctive, lowercase -> BM25 signal)
        self.topic_terms = [
            [_pseudo_word(rng, int(rng.integers(2, 4))) for _ in range(cfg.terms_per_topic)]
            for _ in range(cfg.n_topics)
        ]
        # seeded entity pool: two capitalized pseudo-words + a domain suffix;
        # entity e's home topic is e % n_topics (topic affinity)
        self.entity_names = [
            f"{_pseudo_word(rng, 2).capitalize()} "
            f"{_pseudo_word(rng, 2).capitalize()} "
            f"{_ENTITY_SUFFIX[int(rng.integers(len(_ENTITY_SUFFIX)))]}"
            for _ in range(cfg.n_entities)
        ]

    # -- per-document derivation (the determinism contract) -----------------

    def _topic_of(self, i: int) -> int:
        # a cheap seeded permutation-ish mix so consecutive docs spread over
        # topics (pure function of (seed, i), no resident state)
        return int((i * 2654435761 + self.config.seed * 97) % self.config.n_topics)

    def _topic_entities(self, topic: int) -> list[int]:
        cfg = self.config
        return list(range(topic, cfg.n_entities, cfg.n_topics))

    def doc(self, i: int) -> SynDoc:
        cfg = self.config
        if not (0 <= i < cfg.n_docs):
            raise IndexError(f"doc id {i} outside [0, {cfg.n_docs})")
        rng = np.random.default_rng([cfg.seed, 0xD0C, i])
        topic = self._topic_of(i)
        name, templates, nouns, verbs = _DOMAINS[topic % len(_DOMAINS)]
        terms = self.topic_terms[topic]
        home = self._topic_entities(topic)
        n_ent = min(cfg.entities_per_doc, len(home))
        ents = [
            self.entity_names[home[int(j)]]
            for j in rng.choice(len(home), size=n_ent, replace=False)
        ]
        n_sent = int(rng.integers(cfg.min_sentences, cfg.max_sentences + 1))
        sentences = []
        mentioned: list[str] = []
        for s in range(n_sent):
            t = templates[int(rng.integers(len(templates)))]
            entity = ents[s % len(ents)]
            if "{entity}" in t and entity not in mentioned:
                mentioned.append(entity)
            sentences.append(
                t.format(
                    term=terms[int(rng.integers(len(terms)))],
                    term2=terms[int(rng.integers(len(terms)))],
                    entity=entity,
                    noun=nouns[int(rng.integers(len(nouns)))],
                    verb=verbs[int(rng.integers(len(verbs)))],
                    year=1900 + int(rng.integers(0, 125)),
                    qty=int(rng.integers(2, 97)),
                )
            )
        title = (
            f"{terms[int(rng.integers(len(terms)))].capitalize()} "
            f"{name} report {i}"
        )
        return SynDoc(
            doc_id=i,
            text=title + ". " + " ".join(sentences),
            topic=topic,
            entities=tuple(mentioned),
        )

    # -- streaming access ---------------------------------------------------

    def doc_batches(
        self, batch_size: int, *, start: int = 0, stop: Optional[int] = None
    ) -> Iterator[list[SynDoc]]:
        """Yield documents in ``[start, stop)`` as lists of ``batch_size``
        (last batch may be short). Only one batch is resident at a time."""
        stop = self.config.n_docs if stop is None else min(stop, self.config.n_docs)
        for lo in range(start, stop, batch_size):
            yield [self.doc(i) for i in range(lo, min(lo + batch_size, stop))]

    def texts(self, start: int, stop: int) -> list[str]:
        return [self.doc(i).text for i in range(start, stop)]

    def fit_sample(self, n: int) -> list[str]:
        """Evenly strided sample of document texts for ``IngestPipeline.fit``
        — covers every topic/domain without materializing the corpus (the
        frozen-stats contract then lets the full corpus stream through
        ``encode_docs``)."""
        n = min(n, self.config.n_docs)
        ids = np.linspace(0, self.config.n_docs - 1, num=n, dtype=np.int64)
        return [self.doc(int(i)).text for i in np.unique(ids)]

    # -- queries ------------------------------------------------------------

    def query(self, j: int) -> SynQuery:
        """Query j: a topic-anchored question mentioning a topic term (as a
        double-quoted required keyword) and, half the time, a home entity —
        the operands ``IngestPipeline.encode_queries`` extracts."""
        cfg = self.config
        rng = np.random.default_rng([cfg.seed, 0x9E4, j])
        topic = int(rng.integers(cfg.n_topics))
        terms = self.topic_terms[topic]
        term = terms[int(rng.integers(len(terms)))]
        q = f'what did the "{term}" {_DOMAINS[topic % len(_DOMAINS)][2][0]} show'
        if j % 2 == 0:
            home = self._topic_entities(topic)
            ent = self.entity_names[home[int(rng.integers(len(home)))]]
            q += f" according to {ent}"
        return SynQuery(text=q, topic=topic)

    def queries(self, n: Optional[int] = None) -> list[SynQuery]:
        n = self.config.n_queries if n is None else n
        return [self.query(j) for j in range(n)]
