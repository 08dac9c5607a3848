"""The port's synthetic text corpus (``repro_torch.data.syncorpus``) and
bundled-corpus loader (``repro_torch.data.textcorpus``) against repro's:
the same strings and fields for the same seed and index, across batch
sizes and access orders, for documents, fit samples and queries."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.data import syncorpus as rsyn
from repro.data import textcorpus as rtext
from repro_torch.data import syncorpus as tsyn
from repro_torch.data import textcorpus as ttext

CFGS = {
    "small": dict(n_docs=512, n_topics=16, n_entities=48, n_queries=32, seed=3),
    "default_widths": dict(n_docs=4096, n_queries=64, seed=0),
}


def pair(name):
    kw = CFGS[name]
    return rsyn.SynCorpus(rsyn.SynCorpusConfig(**kw)), tsyn.SynCorpus(tsyn.SynCorpusConfig(**kw))


def same_doc(a, b) -> bool:
    return (a.doc_id, a.text, a.topic, a.entities) == (b.doc_id, b.text, b.topic, b.entities)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_pools_equal_repro(name):
    r, t = pair(name)
    assert t.topic_terms == r.topic_terms
    assert t.entity_names == r.entity_names


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_doc_batches_equal_repro(name, batch):
    r, t = pair(name)
    stop = min(r.config.n_docs, 200)
    got = [d for b in t.doc_batches(batch, start=3, stop=stop) for d in b]
    want = [d for b in r.doc_batches(batch, start=3, stop=stop) for d in b]
    assert len(got) == len(want) == stop - 3
    assert all(same_doc(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_random_access_order_equal_repro(name):
    r, t = pair(name)
    n = r.config.n_docs
    ids = np.random.default_rng(0).permutation(n)[:64].tolist() + [0, n - 1]
    for i in ids:  # shuffled order, then the same ids through texts()
        assert same_doc(t.doc(i), r.doc(i))
    assert t.texts(n - 10, n) == r.texts(n - 10, n)
    with pytest.raises(IndexError):
        t.doc(n)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("n", [5, 300, 10**6])
def test_fit_sample_equal_repro(name, n):
    r, t = pair(name)
    assert t.fit_sample(n) == r.fit_sample(n)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_queries_equal_repro(name):
    r, t = pair(name)
    got, want = t.queries(), r.queries()
    assert [(q.text, q.topic) for q in got] == [(q.text, q.topic) for q in want]
    assert (t.query(1000).text, t.query(1000).topic) == (r.query(1000).text, r.query(1000).topic)


def test_corpus_of_another_length_keeps_every_doc():
    """A longer corpus of the same seed holds the shorter one's docs: the
    writes of a scale run draw docs past the indexed range from it."""
    short = tsyn.SynCorpus(tsyn.SynCorpusConfig(n_docs=100, seed=0))
    long = tsyn.SynCorpus(tsyn.SynCorpusConfig(n_docs=200, seed=0))
    assert short.texts(0, 100) == long.texts(0, 100)
    assert long.doc(150).text == rsyn.SynCorpus(rsyn.SynCorpusConfig(n_docs=200, seed=0)).doc(
        150).text


def test_bundled_corpus_equal_repro():
    got, want = ttext.load_bundled_corpus(), rtext.load_bundled_corpus()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_docs == 120
    np.testing.assert_array_equal(ttext.topic_truth(got.query_topics, got.topics),
                                  rtext.topic_truth(want.query_topics, want.topics))
