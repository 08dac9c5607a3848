"""Loader for the bundled real-text corpus (tests/data/*.jsonl). The port's
own copy of ``repro/data/textcorpus.py``: one place defines how the bundled
paragraphs and queries are read and how the topic ground truth is formed,
for the port's ingest tests and chip_smoke.py's real-text gate.

The corpus is a development asset checked into ``tests/data`` (120 original
topic-clustered paragraphs with recurring named entities); pass
``data_dir`` explicitly when running from an installed package.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np

# src/repro_torch/data/textcorpus.py -> repo root (editable-install layout)
DEFAULT_DATA_DIR = pathlib.Path(__file__).resolve().parents[3] / "tests" / "data"


@dataclasses.dataclass
class TextCorpus:
    texts: list[str]  # "<title>. <body>" per paragraph
    titles: list[str]
    topics: list[str]
    query_texts: list[str]
    query_topics: list[str]

    @property
    def n_docs(self) -> int:
        return len(self.texts)


def load_bundled_corpus(data_dir: Optional[str] = None) -> TextCorpus:
    data = pathlib.Path(data_dir) if data_dir is not None else DEFAULT_DATA_DIR
    paras = [json.loads(l) for l in (data / "paragraphs.jsonl").open()]
    queries = [json.loads(l) for l in (data / "queries.jsonl").open()]
    return TextCorpus(
        texts=[p["title"] + ". " + p["text"] for p in paras],
        titles=[p["title"] for p in paras],
        topics=[p["topic"] for p in paras],
        query_texts=[q["text"] for q in queries],
        query_topics=[q["topic"] for q in queries],
    )


def topic_truth(query_topics: list[str], doc_topics: list[str]) -> np.ndarray:
    """(Q, R) PAD(-1)-padded relevant doc ids: a query's relevant set is
    every paragraph of its topic."""
    width = max(doc_topics.count(t) for t in set(doc_topics))
    truth = np.full((len(query_topics), width), -1, np.int32)
    for i, t in enumerate(query_topics):
        ids = [j for j, dt in enumerate(doc_topics) if dt == t]
        truth[i, : len(ids)] = ids
    return truth
