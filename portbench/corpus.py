"""The benchmark's frozen corpus generator.

A copy of the port's ``data/corpus.make_corpus`` as it stood when the
benchmark was defined: the same draws in the same order, so a corpus made
here equals the port's at the same settings and seed (a CPU test holds the
two together). The program may change its own generator; this one stays, so
every run of a cell searches the same data for the same seed.

Structure: topic clusters for the dense path, Zipf-weighted topic term pools
for the learned-sparse and lexical paths, one rare entity per doc plus common
entities and KG chains (drawn for the stream order, not used by the cells),
and queries built from planted relevant docs with a required keyword where
their relevant docs share one. The bulk draws come from a ``torch.Generator``
on the device, the host-side structure from ``numpy.random.default_rng``,
both seeded with the run's seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAD = -1
_ROW_CHUNK = 65536  # docs generated per step (bounds the temporaries)


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_docs: int
    n_queries: int
    n_topics: int
    d_dense: int
    vocab_sparse: int
    vocab_lexical: int
    nnz_sparse: int
    nnz_lexical: int
    nnz_query_sparse: int
    nnz_query_lexical: int
    terms_per_topic: int
    keywords_per_topic: int
    relevant_per_query: int
    dense_noise: float
    n_common_entities: int
    entities_per_doc: int
    chain_len: int


@dataclasses.dataclass
class Rows:
    """Fused rows: dense (N, Dd) float32, learned and lexical ELL (ids int32,
    PAD padded; values float32, 0 in PAD slots)."""

    dense: torch.Tensor
    learned_idx: torch.Tensor
    learned_val: torch.Tensor
    lexical_idx: torch.Tensor
    lexical_val: torch.Tensor

    @property
    def n(self) -> int:
        return self.dense.shape[0]

    def rows(self, sel) -> "Rows":
        return Rows(*(t[sel] for t in self.tensors()))

    def tensors(self) -> tuple:
        return (self.dense, self.learned_idx, self.learned_val, self.lexical_idx,
                self.lexical_val)


@dataclasses.dataclass
class Corpus:
    spec: CorpusSpec
    docs: Rows
    queries: Rows
    query_keywords: np.ndarray  # (Q, 4) int32, PAD padded: the required keyword in column 0
    query_relevant: np.ndarray  # (Q, R) planted relevant doc ids


def corpus_spec(config: dict, **override) -> CorpusSpec:
    """The corpus settings of a configuration file, some overridden."""
    c = dict(config, **override)
    return CorpusSpec(**{f.name: c[f.name] for f in dataclasses.fields(CorpusSpec)})


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def _zipf(n: int) -> np.ndarray:
    z = 1.0 / np.arange(1, n + 1)
    return z / z.sum()


def _distinct(rng, hi, count: int, size: int) -> np.ndarray:
    """``size`` rows of ``count`` distinct uniform draws from [0, hi)."""
    hi = np.broadcast_to(np.asarray(hi, np.int64), (size,))
    out = np.zeros((size, count), np.int64)
    for j in range(count):
        x = rng.integers(0, hi - j)
        for v in np.sort(out[:, :j], axis=1).T:
            x = x + (x >= v)
        out[:, j] = x
    return out


def _topic_pools(rng, n_topics: int, n_common: int, per_topic: int, vocab: int) -> np.ndarray:
    keys = rng.random((n_topics, vocab - n_common))
    part = np.argpartition(keys, per_topic - 1, axis=1)[:, :per_topic]
    part = np.take_along_axis(part, np.argsort(np.take_along_axis(keys, part, 1), 1), 1)
    common = np.broadcast_to(np.arange(n_common), (n_topics, n_common))
    return np.concatenate([common, n_common + part], axis=1)


def _sample_ell(pools: torch.Tensor, w: torch.Tensor, nnz: int, gen):
    r, l = pools.shape
    k = min(nnz, l)
    u = torch.rand((r, l), generator=gen, device=pools.device).clamp_(1e-12, 1.0)
    sel = torch.topk(torch.log(w)[None, :] - torch.log(-torch.log(u)), k, dim=1).indices
    val = torch.abs(1.0 + 0.3 * torch.randn((r, k), generator=gen, device=pools.device))
    val = val / torch.sqrt(1.0 + 50.0 * w[sel])
    val, order = torch.sort(val, dim=1, descending=True)
    idx = torch.gather(torch.gather(pools, 1, sel), 1, order)
    if k < nnz:
        idx = torch.cat([idx, torch.full((r, nnz - k), PAD, dtype=idx.dtype, device=idx.device)], 1)
        val = torch.cat([val, torch.zeros((r, nnz - k), device=val.device)], 1)
    return idx.to(torch.int32), val.float()


def _ell_rows(rows_idx, rows_val, cap: int):
    n = len(rows_idx)
    idx = np.full((n, cap), PAD, np.int32)
    val = np.zeros((n, cap), np.float32)
    for r, (ii, vv) in enumerate(zip(rows_idx, rows_val)):
        order = np.argsort(-np.asarray(vv), kind="stable")[:cap]
        idx[r, : len(order)] = np.asarray(ii)[order]
        val[r, : len(order)] = np.asarray(vv)[order]
    return idx, val


def make_corpus(spec: CorpusSpec, seed: int, device) -> Corpus:
    """The corpus of ``spec`` for ``seed``, made on ``device``."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nt, n = spec.n_topics, spec.n_docs

    centers = _unit(torch.randn((nt, spec.d_dense), generator=gen, device=dev))
    n_common = max(spec.terms_per_topic // 2, 8)
    n_common_kw = max(spec.keywords_per_topic // 2, 4)
    terms = torch.as_tensor(
        _topic_pools(rng, nt, n_common, spec.terms_per_topic, spec.vocab_sparse), device=dev)
    kws = torch.as_tensor(
        _topic_pools(rng, nt, n_common_kw, spec.keywords_per_topic, spec.vocab_lexical),
        device=dev)
    w_terms = torch.as_tensor(_zipf(terms.shape[1]), dtype=torch.float32, device=dev)
    w_kws = torch.as_tensor(_zipf(kws.shape[1]), dtype=torch.float32, device=dev)

    doc_topics = rng.integers(0, nt, size=n).astype(np.int32)
    topics_d = torch.as_tensor(doc_topics, device=dev).long()
    dense = torch.empty((n, spec.d_dense), dtype=torch.float32, device=dev)
    s_idx, s_val, f_idx, f_val = [], [], [], []
    for s in range(0, n, _ROW_CHUNK):
        t = topics_d[s:s + _ROW_CHUNK]
        noise = torch.randn((len(t), spec.d_dense), generator=gen, device=dev)
        dense[s:s + len(t)] = _unit(centers[t] + spec.dense_noise * noise)
        si, sv = _sample_ell(terms[t], w_terms, spec.nnz_sparse, gen)
        fi, fv = _sample_ell(kws[t], w_kws, spec.nnz_lexical, gen)
        s_idx.append(si)
        s_val.append(sv)
        f_idx.append(fi)
        f_val.append(fv)
        # the common-entity draw of the stream (its values are not used here)
        torch.rand((len(t), spec.n_common_entities), generator=gen, device=dev)
    docs = Rows(dense, torch.cat(s_idx), torch.cat(s_val), torch.cat(f_idx), torch.cat(f_val))

    # entity and chain draws keep the host stream in step with the port's
    rng.integers(0, spec.entities_per_doc, size=n)
    n_chains = max(spec.n_queries, n // 16)
    _distinct(rng, n, spec.chain_len, n_chains)
    rng.integers(0, 64, size=(n_chains, spec.chain_len - 1))
    _distinct(rng, spec.n_common_entities, 2, spec.n_common_entities)
    rng.integers(0, 64, spec.n_common_entities)

    q, r = spec.n_queries, spec.relevant_per_query
    qt = rng.integers(0, nt, size=q).astype(np.int32)
    by_topic = np.argsort(doc_topics, kind="stable")
    counts = np.bincount(doc_topics, minlength=nt)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    small = counts[qt] < r
    pick = _distinct(rng, np.where(small, n, counts[qt]), r, q)
    q_rel = np.where(small[:, None], pick, by_topic[starts[qt][:, None] + pick]).astype(np.int32)

    rel_d = torch.as_tensor(q_rel, device=dev).long()
    noise = torch.randn((q, spec.d_dense), generator=gen, device=dev)
    q_dense = _unit(dense[rel_d].mean(1) + 0.5 * spec.dense_noise * noise)
    rel_s = docs.learned_idx[rel_d].cpu().numpy()
    rel_f = docs.lexical_idx[rel_d].cpu().numpy()
    qsi, qsv, qfi, qfv = [], [], [], []
    q_keywords = np.full((q, 4), PAD, np.int32)
    for i in range(q):
        pool = np.unique(rel_s[i][rel_s[i] >= 0])
        sel = rng.choice(pool, size=min(spec.nnz_query_sparse, len(pool)), replace=False)
        qsi.append(sel)
        qsv.append(np.abs(rng.normal(1.0, 0.3, size=len(sel))).astype(np.float32))
        pool = np.unique(rel_f[i][rel_f[i] >= 0])
        sel = rng.choice(pool, size=min(spec.nnz_query_lexical, len(pool)), replace=False)
        qfi.append(sel)
        qfv.append(np.abs(rng.normal(1.0, 0.3, size=len(sel))).astype(np.float32))
        shared = set(rel_f[i][0][rel_f[i][0] >= 0].tolist())
        for row in rel_f[i][1:]:
            shared &= set(row[row >= 0].tolist())
        if shared:
            q_keywords[i, 0] = sorted(shared)[0]
    qs_idx, qs_val = _ell_rows(qsi, qsv, spec.nnz_query_sparse)
    qf_idx, qf_val = _ell_rows(qfi, qfv, spec.nnz_query_lexical)
    t = lambda a: torch.as_tensor(a, device=dev)
    queries = Rows(q_dense, t(qs_idx), t(qs_val), t(qf_idx), t(qf_val))
    return Corpus(spec, docs, queries, q_keywords, q_rel)
