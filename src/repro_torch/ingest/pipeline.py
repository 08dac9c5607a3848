"""Corpus-level ingestion: raw documents -> everything the index consumes.
Port of ``repro/ingest/pipeline.py``.

``IngestPipeline`` batches documents through the analyzer, the BM25/TF-IDF
weighting, and the entity extractor, producing in one fitting pass:

  * ``FusedVectors`` — hashed-projection dense + TF-IDF learned-sparse +
    BM25 lexical ELL vectors (the lexical ids double as the keyword set
    K(·) consumed by keyword edges and keyword-constrained search);
  * ``doc_entities`` (N, Ed) + ``KnowledgeGraph``-compatible (s, r, t)
    triplets for ``core.logical_edges.build_logical_edges``;
  * frozen ``CorpusStats`` (df, avg doc length) + frozen ``EntityVocab``.

After ``fit`` the statistics are FROZEN: ``encode_docs``/``encode_queries``
weight new text with the fitted df/avg_dl and only recognize fitted
entities. That is the streaming contract — vectors of already-indexed
documents never change value and inserts through ``SegmentRouter.insert``
stay pure appends (DESIGN.md §7).

Tokenizing, statistics and weighting are host numpy in the same float order
as ``repro``'s, so every encoded array is bit-identical to ``repro``'s; the
vectors become tensors only at the end, on the pipeline's device (CUDA
unless ``device="cpu"``). Builds take a ``torch.Generator`` and optional
draws where ``repro`` takes a key.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.build_pipeline import BuildDraws, build_index
from repro_torch.core.index import BuildConfig, HybridIndex
from repro_torch.core.usms import PAD_IDX, FusedVectors
from repro_torch.data.corpus import KnowledgeGraph
from repro_torch.device import resolve_device
from repro_torch.ingest.analyzer import (
    AnalyzerConfig,
    learned_id,
    lexical_id,
    quoted_phrases,
    term_counts,
    tokenize,
)
from repro_torch.ingest.entities import (
    EntityVocab,
    cooccurrence_triplets,
    doc_entity_ids,
    extract_entity_spans,
)
from repro_torch.ingest.weighting import (
    CorpusStats,
    bm25_weights,
    hashed_dense_embedding,
    make_projection,
    tfidf_weights,
    to_ell,
)


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    analyzer: AnalyzerConfig = AnalyzerConfig()
    d_dense: int = 64
    nnz_learned: int = 32  # doc-side ELL caps (top-P terms per doc)
    nnz_lexical: int = 16
    nnz_query_learned: int = 16
    nnz_query_lexical: int = 8
    query_keyword_cap: int = 4  # required-keyword slots per query
    query_entity_cap: int = 2
    max_entities: int = 512
    entities_per_doc: int = 4
    min_cooc: int = 2  # docs an entity pair must share to earn a triplet
    normalize_sparse: bool = True  # L2-balance sparse rows against dense
    embed_seed: int = 0
    gazetteer: tuple[str, ...] = ()


@dataclasses.dataclass
class IngestedCorpus:
    """Fit output: exactly what ``build_index``/``build_segmented_index``
    consume, plus the KG for the router."""

    docs: FusedVectors  # tensors on the pipeline's device
    doc_entities: np.ndarray  # (N, Ed) int32 PAD-padded
    kg: KnowledgeGraph
    doc_lengths: np.ndarray  # (N,) analyzed token counts (diagnostics)

    @property
    def n_docs(self) -> int:
        return self.docs.dense.shape[0]


@dataclasses.dataclass
class EncodedQueries:
    """Query-side encoding: the three operands the search path takes."""

    vectors: FusedVectors  # tensors on the pipeline's device
    keywords: np.ndarray  # (B, Kw) required keyword ids, PAD-padded
    entities: np.ndarray  # (B, Eq) entity ids, PAD-padded


def adaptive_fusion_for(enc: EncodedQueries, *, stats=None):
    """Per-query ``FusionSpec`` from an encoded query batch — the ingest
    side of the adaptive fusion selector (``core.fusion.adaptive_fusion``):
    required-keyword count, live lexical nnz, and entity presence pick the
    mode and weights per row. Pass a service's (or a tier's) running
    ``PathStats`` to pin normalization; otherwise it resolves downstream."""
    from repro_torch.core.fusion import adaptive_fusion, query_nnz

    return adaptive_fusion(enc.keywords, enc.entities, query_nnz(enc.vectors), stats=stats)


class NotFittedError(RuntimeError):
    pass


class IngestPipeline:
    """One-pass fit, frozen-stats encode, and index assembly, with the
    encoded tensors on ``device`` (``None`` -> CUDA; raises when CUDA is
    absent)."""

    def __init__(self, config: Optional[IngestConfig] = None, *, device=None):
        self.config = config or IngestConfig()
        self.device = resolve_device(device)
        self.stats: Optional[CorpusStats] = None
        self.entity_vocab: Optional[EntityVocab] = None
        self.n_triplets: int = 0  # 0 => indexes built from this fit carry no KG
        self._projection: Optional[np.ndarray] = None

    # -- fitting ------------------------------------------------------------

    @property
    def fitted(self) -> bool:
        return self.stats is not None

    def _require_fitted(self):
        if not self.fitted:
            raise NotFittedError(
                "IngestPipeline.fit(texts) must run before encoding: the "
                "frozen corpus stats (df, avg_dl) and entity vocab are what "
                "keep streamed vectors consistent with the sealed index"
            )

    @property
    def projection(self) -> np.ndarray:
        if self._projection is None:
            self._projection = make_projection(
                self.config.analyzer.vocab_size, self.config.d_dense, self.config.embed_seed)
        return self._projection

    def _check_dense(self, dense_vectors, n: int) -> Optional[np.ndarray]:
        """Validate caller-supplied embeddings (the embedder plug-in point:
        any real model's vectors replace the hashed-projection stub)."""
        if dense_vectors is None:
            return None
        if isinstance(dense_vectors, torch.Tensor):
            dense_vectors = dense_vectors.detach().cpu().numpy()
        dense = np.asarray(dense_vectors, np.float32)
        if dense.shape != (n, self.config.d_dense):
            raise ValueError(
                f"dense_vectors must be ({n}, {self.config.d_dense}) to "
                f"match the document count and IngestConfig.d_dense; got "
                f"{dense.shape}"
            )
        return dense

    def _spans(self, texts: Sequence[str]) -> list[list[str]]:
        gaz = self.config.gazetteer or None
        return [extract_entity_spans(t, gazetteer=gaz) for t in texts]

    def fit(self, texts: Sequence[str], *, dense_vectors=None) -> IngestedCorpus:
        """One pass over the corpus: analyze, accumulate df/avg_dl, build
        the entity vocab + co-occurrence triplets, then encode every doc
        with the just-frozen statistics. ``dense_vectors`` (N, d_dense)
        supplies precomputed embeddings in place of the hashed-projection
        stub — queries and later inserts must then come from the SAME
        embedder."""
        if self.fitted:
            raise RuntimeError(
                "pipeline already fitted; stats are frozen — use "
                "encode_docs() for new documents or a fresh pipeline to refit"
            )
        cfg = self.config
        acfg = cfg.analyzer
        learned, lexical, lengths = self._analyze(texts)
        self.stats = CorpusStats.from_docs(
            learned, lexical, lengths, acfg.vocab_size, acfg.lexical_vocab_size)
        spans = self._spans(texts)
        self.entity_vocab = EntityVocab.build(
            Counter(s for doc in spans for s in doc), cfg.max_entities)
        doc_ents = doc_entity_ids(spans, self.entity_vocab, cfg.entities_per_doc)
        triplets = cooccurrence_triplets(doc_ents, len(self.entity_vocab), cfg.min_cooc)
        self.n_triplets = int(len(triplets))
        kg = KnowledgeGraph(triplets, n_entities=max(len(self.entity_vocab), 1))
        docs = self._encode_counts(
            learned, lexical, lengths, cfg.nnz_learned, cfg.nnz_lexical,
            dense=self._check_dense(dense_vectors, len(texts)))
        return IngestedCorpus(
            docs=docs,
            doc_entities=doc_ents,
            kg=kg,
            doc_lengths=np.asarray(lengths, np.int32),
        )

    # -- frozen-stats encoding ----------------------------------------------

    def _analyze(self, texts: Sequence[str]):
        """The one analysis path (docs AND queries): tokenize once, fold
        into both hashed id spaces, keep analyzed lengths."""
        acfg = self.config.analyzer
        analyzed = [tokenize(t, acfg) for t in texts]
        return (
            [term_counts(a, learned_id, acfg) for a in analyzed],
            [term_counts(a, lexical_id, acfg) for a in analyzed],
            [len(a) for a in analyzed],
        )

    def _encode_counts(self, learned, lexical, lengths, nnz_l, nnz_f, *,
                       dense=None) -> FusedVectors:
        tfidf_rows = [tfidf_weights(c, self.stats) for c in learned]
        bm25_rows = [bm25_weights(c, dl, self.stats) for c, dl in zip(lexical, lengths)]
        if dense is None:  # the hashed-projection stub is only the fallback
            dense = hashed_dense_embedding(tfidf_rows, self.projection)
        norm, dev = self.config.normalize_sparse, self.device
        return FusedVectors(torch.from_numpy(np.ascontiguousarray(dense)).to(dev),
                            to_ell(tfidf_rows, nnz_l, normalize=norm, device=dev),
                            to_ell(bm25_rows, nnz_f, normalize=norm, device=dev))

    def encode_docs(self, texts: Sequence[str], *,
                    dense_vectors=None) -> tuple[FusedVectors, np.ndarray]:
        """Encode new documents with the FROZEN stats (streaming path).
        Entities unseen at fit time map to PAD (dropped until a refit).
        ``dense_vectors`` (N, d_dense) plugs in a real embedder's vectors
        for these docs (use the same embedder the index was built with)."""
        self._require_fitted()
        cfg = self.config
        learned, lexical, lengths = self._analyze(texts)
        docs = self._encode_counts(
            learned, lexical, lengths, cfg.nnz_learned, cfg.nnz_lexical,
            dense=self._check_dense(dense_vectors, len(texts)))
        ents = doc_entity_ids(self._spans(texts), self.entity_vocab, cfg.entities_per_doc)
        return docs, ents

    def encode_queries(self, texts: Sequence[str], *, dense_vectors=None) -> EncodedQueries:
        """Same tokenizer on the query side: TF-IDF/BM25 query vectors,
        double-quoted phrases -> required keywords, capitalized spans
        matched against the frozen vocab -> query entities.

        Keyword semantics: a doc's keyword set K(doc) is its TOP-
        ``nnz_lexical`` BM25 terms (the fixed-nnz ELL contract), not its
        full term set — a required keyword only matches docs where the term
        ranks among their strongest; quote *distinctive* terms."""
        self._require_fitted()
        cfg = self.config
        acfg = cfg.analyzer
        learned, lexical, lengths = self._analyze(texts)
        vectors = self._encode_counts(
            learned, lexical, lengths, cfg.nnz_query_learned, cfg.nnz_query_lexical,
            dense=self._check_dense(dense_vectors, len(texts)))
        b = len(texts)
        kw = np.full((b, max(cfg.query_keyword_cap, 1)), PAD_IDX, np.int32)
        en = np.full((b, max(cfg.query_entity_cap, 1)), PAD_IDX, np.int32)
        for i, text in enumerate(texts):
            req: list[int] = []
            for phrase in quoted_phrases(text):
                for term in tokenize(phrase, acfg):
                    tid = lexical_id(term, acfg)
                    if tid not in req:
                        req.append(tid)
            kw[i, : len(req[: cfg.query_keyword_cap])] = req[: cfg.query_keyword_cap]
            ents: list[int] = []
            for span in extract_entity_spans(text, gazetteer=cfg.gazetteer or None):
                e = self.entity_vocab.lookup(span)
                if e != PAD_IDX and e not in ents:
                    ents.append(e)
            en[i, : len(ents[: cfg.query_entity_cap])] = ents[: cfg.query_entity_cap]
        return EncodedQueries(vectors=vectors, keywords=kw, entities=en)

    # -- index assembly -----------------------------------------------------

    def _kg_kwargs(self, ingested: IngestedCorpus) -> dict:
        if len(ingested.kg.triplets) == 0:
            return {}
        return dict(kg_triplets=ingested.kg.triplets, doc_entities=ingested.doc_entities,
                    n_entities=ingested.kg.n_entities)

    def build(self, ingested: IngestedCorpus, build_cfg: Optional[BuildConfig] = None, *,
              generator: Optional[torch.Generator] = None,
              draws: Optional[BuildDraws] = None) -> HybridIndex:
        """Hand the fitted corpus to ``build_index`` (Algorithm 1) on the
        pipeline's device."""
        return build_index(ingested.docs, build_cfg or BuildConfig(), generator=generator,
                           draws=draws, device=self.device, **self._kg_kwargs(ingested))

    def build_sharded(self, ingested: IngestedCorpus, n_segments: int,
                      build_cfg: Optional[BuildConfig] = None, *, mesh=None,
                      generator: Optional[torch.Generator] = None,
                      seed: Optional[int] = None, draws=None):
        """Segment-sharded build (``SegmentedIndex`` for the serving layer):
        with a ``mesh``, every segment builds in parallel across the ranks
        (``build_index_sharded``, collective: segment s draws from ``seed +
        s``, default seed 0); without one, the segments build one after
        another on the pipeline's device (``build_segmented_index``, from
        ``generator`` or, given ``seed``, as the mesh build draws).
        ``draws[s]`` (optional) are segment s's draws."""
        from repro_torch.core.distributed import build_index_sharded, build_segmented_index

        cfg = build_cfg or BuildConfig()
        if mesh is not None:
            if generator is not None:
                raise ValueError("a sharded build over a mesh draws from a seed, not a generator")
            return build_index_sharded(ingested.docs, n_segments, cfg, mesh=mesh,
                                       seed=0 if seed is None else seed, draws=draws,
                                       **self._kg_kwargs(ingested))
        return build_segmented_index(
            ingested.docs, n_segments, cfg, generator=generator, seed=seed, draws=draws,
            device=self.device, **self._kg_kwargs(ingested))

    def stream_into(self, target, texts: Sequence[str], *,
                    generator: Optional[torch.Generator] = None, draws=None,
                    with_entities: Optional[bool] = None, dense_vectors=None):
        """Streaming ingestion: encode ``texts`` with the frozen stats and
        insert them through ``target.insert`` (a ``HybridSearchService``,
        a ``SegmentRouter`` or a ``ReplicaRouter``). Entities ride along
        exactly when the fit produced triplets — the same condition under
        which ``build``/``build_sharded`` gave the index a KG (and the
        router its entity width); override with ``with_entities``. Pass
        ``dense_vectors`` (N, d_dense) when the index was built from a real
        embedder rather than the hashed stub. ``generator``/``draws`` are
        passed on only when given. Returns what ``target.insert`` returns
        (a snapshot version; a tier's allocated global ids)."""
        self._require_fitted()
        docs, ents = self.encode_docs(texts, dense_vectors=dense_vectors)
        if with_entities is None:
            with_entities = self.n_triplets > 0
        kwargs = {"new_doc_entities": ents} if with_entities else {}
        if generator is not None:
            kwargs["generator"] = generator
        if draws is not None:
            kwargs["draws"] = draws
        return target.insert(docs, **kwargs)

    # -- persistence (the ingestion side of save_index/load_index) ----------

    MANIFEST = "ingest_manifest.json"
    ARRAYS = "ingest_arrays.npz"

    @staticmethod
    def _old_prefix(directory: pathlib.Path) -> str:
        # recovery copies are namespaced per target directory, so sibling
        # ingest dirs under one parent never clean up each other's copies
        return f".old_{directory.name}_"

    def save(self, directory: str | os.PathLike) -> None:
        """Vocab/corpus-stats manifest written crash-safely (tmp dir +
        rename, with any previous manifest renamed aside rather than
        deleted), in ``repro``'s layout: a directory either package's
        ``load`` reads."""
        self._require_fitted()
        directory = pathlib.Path(directory)
        directory.parent.mkdir(parents=True, exist_ok=True)
        tmp = pathlib.Path(tempfile.mkdtemp(dir=directory.parent, prefix=".tmp_ingest_"))
        manifest = {
            "config": dataclasses.asdict(self.config),
            "stats": {"n_docs": self.stats.n_docs, "avg_dl": self.stats.avg_dl},
            "entity_names": list(self.entity_vocab.names),
            "n_triplets": self.n_triplets,
        }
        (tmp / self.MANIFEST).write_text(json.dumps(manifest))
        np.savez(tmp / self.ARRAYS, df_learned=self.stats.df_learned,
                 df_lexical=self.stats.df_lexical)
        # the old manifest is renamed aside (never deleted in place) before
        # the new one swings in, and ``load`` falls back to the newest
        # renamed-aside copy: a crash at any point leaves a loadable copy
        if directory.exists():
            old = pathlib.Path(tempfile.mkdtemp(dir=directory.parent,
                                                prefix=self._old_prefix(directory)))
            os.rmdir(old)
            os.rename(directory, old)
        os.rename(tmp, directory)
        for stale in directory.parent.glob(self._old_prefix(directory) + "*"):
            shutil.rmtree(stale, ignore_errors=True)

    @classmethod
    def load(cls, directory: str | os.PathLike, *, device=None) -> "IngestPipeline":
        """A fitted pipeline from a directory either package's ``save``
        wrote, encoding onto ``device`` (``None`` -> CUDA)."""
        directory = pathlib.Path(directory)
        if not (directory / cls.MANIFEST).exists():
            # a save crashed between its two renames: the committed copy
            # lives in the newest renamed-aside copy of this directory
            olds = sorted(
                (d for d in directory.parent.glob(cls._old_prefix(directory) + "*")
                 if (d / cls.MANIFEST).exists()),
                key=lambda d: d.stat().st_mtime,
            )
            if not olds:
                raise FileNotFoundError(
                    f"no ingest manifest at {directory} (and no renamed-aside copy to recover)")
            directory = olds[-1]
        manifest = json.loads((directory / cls.MANIFEST).read_text())
        arrays = np.load(directory / cls.ARRAYS)
        return cls.from_state(
            manifest["config"], n_docs=manifest["stats"]["n_docs"],
            avg_dl=manifest["stats"]["avg_dl"], df_learned=arrays["df_learned"],
            df_lexical=arrays["df_lexical"], entity_names=manifest["entity_names"],
            n_triplets=manifest.get("n_triplets", 0), device=device)

    @classmethod
    def from_state(cls, config: dict, *, n_docs: int, avg_dl: float, df_learned, df_lexical,
                   entity_names, n_triplets: int = 0, device=None) -> "IngestPipeline":
        """A fitted pipeline from its state: the config as a dict of
        ``IngestConfig``'s fields (``analyzer`` a dict of
        ``AnalyzerConfig``'s), the frozen stats, the entity names in id
        order and the triplet count."""
        cfg_d = dict(config)
        a = dict(cfg_d.pop("analyzer"))
        a["extra_stopwords"] = tuple(a.get("extra_stopwords", ()))
        cfg_d["gazetteer"] = tuple(cfg_d.get("gazetteer", ()))
        pipe = cls(IngestConfig(analyzer=AnalyzerConfig(**a), **cfg_d), device=device)
        pipe.stats = CorpusStats(
            n_docs=int(n_docs), avg_dl=float(avg_dl),
            df_learned=np.asarray(df_learned, np.int32),
            df_lexical=np.asarray(df_lexical, np.int32))
        pipe.entity_vocab = EntityVocab(names=list(entity_names))
        pipe.n_triplets = int(n_triplets)
        return pipe
