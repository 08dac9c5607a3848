"""Retrieve-then-generate (``repro/serving/rag.py``): the hybrid index as a
feature of the serving path.

A RAG request carries the query's fused vectors and optional required
keywords and entities. The pipeline is:

  1. hybrid search on the index, either a direct ``search()`` call or,
     with an attached ``HybridSearchService``, through the micro-batched
     serving path;
  2. retrieved doc ids -> context token prefixes (the synthetic corpus maps
     doc ids to token spans; ids are clipped to [0, N-1], so PAD becomes
     doc 0, as in ``repro``);
  3. batched generation conditioned on [context ; prompt].

With an attached ``ingest.IngestPipeline`` the request side starts from raw
text: ``retrieve_text``/``answer_text`` run the same analyzer the corpus was
ingested with (query dense + TF-IDF/BM25 ``SparseVec``, double-quoted
phrases as required keywords, capitalized spans matched against the frozen
entity vocab as query entities), and ``RagConfig.adaptive`` picks the fusion
mode and weights per query from the analyzer's signals.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core.fusion import FusionSpec, adaptive_fusion, as_fusion_spec, query_nnz
from repro_torch.core.index import HybridIndex
from repro_torch.core.search import SearchParams, SearchResult, resolve_params, search
from repro_torch.core.usms import FusedVectors
from repro_torch.obs.tracer import TraceContext
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.hybrid_service import HybridSearchService

@dataclasses.dataclass
class RagConfig:
    top_k: int = 4
    ctx_tokens_per_doc: int = 32
    # the query-side fusion object; stats resolve against the attached
    # service's running corpus stats (identity when direct)
    fusion: FusionSpec = dataclasses.field(default_factory=FusionSpec.three_path)
    # pick mode + weights per query from its text-derived characteristics
    # (keyword count, lexical nnz, entity presence) on the text entry points
    adaptive: bool = False
    search: SearchParams = SearchParams(k=4, iters=32, pool_size=64)


class RagPipeline:
    def __init__(
        self,
        engine: ServingEngine,
        index: HybridIndex,
        doc_tokens: torch.Tensor,  # (N_docs, ctx_tokens_per_doc) int32
        cfg: RagConfig,
        *,
        service: Optional[HybridSearchService] = None,
        ingest=None,  # a fitted ingest.IngestPipeline, for text queries
    ):
        self.engine = engine
        self.index = index
        self.doc_tokens = doc_tokens
        self.cfg = cfg
        self.service = service
        self.ingest = ingest
        if ingest is not None and not getattr(ingest, "fitted", False):
            raise ValueError(
                "RagPipeline needs a FITTED IngestPipeline: the query-side "
                "analyzer must use the same frozen corpus stats the index "
                "was built from"
            )
        if service is not None:
            # retrieval runs with the service's SearchParams; refuse a config
            # that silently diverges from it (k may differ: the service caps
            # per-request k, cfg.top_k just has to fit under it)
            resolved = resolve_params(dataclasses.replace(cfg.search, k=service.params.k))
            if resolved != service.params:
                raise ValueError(
                    "RagConfig.search and the attached service's SearchParams "
                    f"disagree: {cfg.search} vs {service.params}"
                )
            if cfg.top_k > service.params.k:
                raise ValueError(
                    f"top_k={cfg.top_k} exceeds the service cap k={service.params.k}"
                )

    def retrieve(
        self,
        queries: FusedVectors,
        *,
        keywords=None,
        entities=None,
        fusion: Optional[FusionSpec] = None,
        trace: Optional[TraceContext] = None,
    ) -> SearchResult:
        spec = self.cfg.fusion if fusion is None else as_fusion_spec(fusion)
        if self.service is not None:
            # keyword/entity operands are inert when the params disable those
            # paths, as on the direct path; the trace rides the requests
            return self.service.search(
                queries, spec,
                keywords=keywords if self.service.params.use_keywords else None,
                entities=entities if self.service.params.use_kg else None,
                k=self.cfg.top_k,
                trace=trace,
            )
        params = dataclasses.replace(self.cfg.search, k=self.cfg.top_k)
        t0 = time.perf_counter()
        res = search(self.index, queries, spec, params, keywords=keywords, entities=entities,
                     device=self.index.semantic_edges.device)
        if trace is not None:
            trace.add_span("retrieval", t0, time.perf_counter(), path="direct")
        return res

    def _adaptive_spec(self, enc) -> FusionSpec:
        """Per-query fusion selection from the analyzer's view of the query:
        required-keyword count, lexical nnz and entity presence pick mode +
        weights per row. Normalization stats pin to the attached service's
        running stats when there is one, else resolve downstream."""
        stats = self.service.path_stats if self.service is not None else None
        return adaptive_fusion(enc.keywords, enc.entities, query_nnz(enc.vectors), stats=stats)

    def _encode(self, texts, what: str):
        if self.ingest is None:
            raise ValueError(f"{what} requires an IngestPipeline at construction")
        return self.ingest.encode_queries(list(texts))

    def retrieve_text(self, texts, *, trace: Optional[TraceContext] = None) -> SearchResult:
        """Raw query strings -> hybrid retrieval through the attached
        analyzer (query SparseVec + required keywords + query entities).
        With ``cfg.adaptive`` the fusion mode and weights are selected per
        query from the analyzer's signals."""
        t0 = time.perf_counter()
        enc = self._encode(texts, "retrieve_text")
        if trace is not None:
            trace.add_span("query_encode", t0, time.perf_counter(), queries=len(texts))
        return self.retrieve(
            enc.vectors, keywords=enc.keywords, entities=enc.entities,
            fusion=self._adaptive_spec(enc) if self.cfg.adaptive else None, trace=trace)

    def answer_text(self, texts, prompts: torch.Tensor, n_tokens: int, *,
                    trace: Optional[TraceContext] = None) -> tuple[torch.Tensor, SearchResult]:
        """Text-query counterpart of ``answer`` (the same retrieval-to-
        generation tail; only the query encoding differs)."""
        enc = self._encode(texts, "answer_text")
        return self.answer(
            enc.vectors, prompts, n_tokens, keywords=enc.keywords, entities=enc.entities,
            fusion=self._adaptive_spec(enc) if self.cfg.adaptive else None, trace=trace)

    def build_context(self, result: SearchResult) -> torch.Tensor:
        """Concatenate retrieved docs' token spans -> (B, top_k * ctx_len)."""
        ids = result.ids[:, : self.cfg.top_k].to(self.doc_tokens.device).long()
        ids = ids.clamp(0, self.doc_tokens.shape[0] - 1)
        ctx = self.doc_tokens[ids]  # (B, k, ctx_len)
        return ctx.reshape(ctx.shape[0], -1)

    def answer(
        self,
        queries: FusedVectors,
        prompts: torch.Tensor,  # (B, Lp)
        n_tokens: int,
        *,
        keywords=None,
        entities=None,
        fusion: Optional[FusionSpec] = None,
        trace: Optional[TraceContext] = None,
    ) -> tuple[torch.Tensor, SearchResult]:
        """Retrieve, assemble [context ; prompt], generate. Returns (tokens
        (B, top_k * ctx_len + Lp + n_tokens), the retrieval result)."""
        res = self.retrieve(queries, keywords=keywords, entities=entities, fusion=fusion,
                            trace=trace)
        t0 = time.perf_counter()
        ctx = self.build_context(res)
        full_prompt = torch.cat([ctx, prompts.to(ctx.device, ctx.dtype)], dim=1)
        t1 = time.perf_counter()
        out = self.engine.generate(full_prompt, n_tokens, trace=trace)
        if trace is not None:
            trace.add_span("context_assembly", t0, t1, top_k=self.cfg.top_k)
            trace.add_span("generation", t1, time.perf_counter(), n_tokens=n_tokens)
        return out, res
