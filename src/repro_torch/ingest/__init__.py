"""Text ingestion: raw documents -> USMS vectors, keywords, KG triplets.
Port of ``repro/ingest``."""

from repro_torch.ingest.analyzer import AnalyzerConfig, tokenize
from repro_torch.ingest.entities import EntityVocab, extract_entity_spans
from repro_torch.ingest.pipeline import (
    EncodedQueries,
    IngestConfig,
    IngestedCorpus,
    IngestPipeline,
    NotFittedError,
    adaptive_fusion_for,
)
from repro_torch.ingest.weighting import CorpusStats

__all__ = [
    "AnalyzerConfig",
    "tokenize",
    "EntityVocab",
    "extract_entity_spans",
    "EncodedQueries",
    "IngestConfig",
    "IngestedCorpus",
    "IngestPipeline",
    "NotFittedError",
    "adaptive_fusion_for",
    "CorpusStats",
]
