"""The benchmark's frozen corpus generator against the port's own."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from portbench.tests.conftest import SEED, TINY_CONFIG

from portbench import harness
from portbench.corpus import corpus_spec, make_corpus


def test_frozen_generator_equals_the_ports():
    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.data.corpus import make_corpus as port_corpus

    cfg = dict(harness.configuration("nq-hybrid-fp32"), **TINY_CONFIG)
    spec = corpus_spec(cfg)
    ours = make_corpus(spec, SEED, "cpu")
    fields = {f.name for f in dataclasses.fields(CorpusConfig)}
    theirs = port_corpus(CorpusConfig(**{k: v for k, v in dataclasses.asdict(spec).items()
                                         if k in fields}, seed=SEED), device="cpu")
    for got, want in ((ours.docs, theirs.docs), (ours.queries, theirs.queries)):
        pairs = zip(got.tensors(), want.tensors())
        assert all(torch.equal(a, b) for a, b in pairs)
    assert np.array_equal(ours.query_keywords, theirs.query_keywords)
    assert np.array_equal(ours.query_relevant, theirs.query_relevant)


def test_same_seed_same_inputs_other_seed_other_inputs():
    spec = corpus_spec(dict(harness.configuration("msmarco-hybrid-int8"), **TINY_CONFIG))
    a, b, c = (make_corpus(spec, s, "cpu") for s in (SEED, SEED, SEED + 1))
    assert all(torch.equal(x, y) for x, y in zip(a.docs.tensors(), b.docs.tensors()))
    assert not torch.equal(a.docs.dense, c.docs.dense)
