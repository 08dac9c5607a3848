"""Synthetic corpora with planted structure. Port of ``repro/data/corpus.py``.

Same structure and parameters as ``repro``'s generator (topic clusters for
the dense path, Zipf-weighted topic term pools for the learned-sparse and
lexical paths, one rare entity per doc plus common entities, KG chains over
rare entities, queries with planted relevant docs, a required keyword and a
multi-hop target), but vectorised so that 2^20 docs take seconds rather than
minutes: the per-doc Zipf sampling without replacement is Gumbel top-k on the
device, the entity and chain draws are batched. The draws differ from
``repro``'s, so the two generators agree in structure, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.usms import PAD_IDX, FusedVectors, SparseVec
from repro_torch.device import resolve_device

_ROW_CHUNK = 65536  # docs generated per step (bounds the temporaries)


@dataclasses.dataclass
class CorpusConfig:
    n_docs: int = 4096
    n_queries: int = 64
    n_topics: int = 64
    d_dense: int = 128
    vocab_sparse: int = 30522  # SPLADE vocab size (paper Table 1)
    vocab_lexical: int = 8192
    nnz_sparse: int = 32  # fixed-nnz cap (ELL)
    nnz_lexical: int = 16
    nnz_query_sparse: int = 16
    nnz_query_lexical: int = 8
    terms_per_topic: int = 64
    keywords_per_topic: int = 24
    relevant_per_query: int = 3
    dense_noise: float = 0.35
    n_common_entities: int = 128
    entities_per_doc: int = 4
    chain_len: int = 3  # multi-hop chains: e0 -r-> e1 -r-> e2
    seed: int = 0

    @property
    def n_entities(self) -> int:
        return self.n_docs + self.n_common_entities


@dataclasses.dataclass
class KnowledgeGraph:
    triplets: np.ndarray  # (T, 3) int32 (src_entity, rel, dst_entity)
    n_entities: int


@dataclasses.dataclass
class SyntheticCorpus:
    config: CorpusConfig
    docs: FusedVectors  # (N, ...) on the device
    doc_entities: np.ndarray  # (N, E) int32 PAD-padded
    doc_topics: np.ndarray  # (N,) int32
    kg: KnowledgeGraph
    queries: FusedVectors  # (Q, ...) on the device
    query_entities: np.ndarray  # (Q, 2) int32
    query_relevant: np.ndarray  # (Q, R) planted relevant doc ids
    query_keywords: np.ndarray  # (Q, 4) required-keyword ids (PAD padded)
    query_multihop_target: np.ndarray  # (Q,) chain-tail doc id, or -1


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def _zipf(n: int) -> np.ndarray:
    z = 1.0 / np.arange(1, n + 1)
    return z / z.sum()


def _distinct(rng, hi: np.ndarray | int, count: int, size: int) -> np.ndarray:
    """``size`` rows of ``count`` distinct uniform draws from [0, hi):
    draw the j-th in [0, hi - j) and step it past the earlier ones."""
    hi = np.broadcast_to(np.asarray(hi, np.int64), (size,))
    out = np.zeros((size, count), np.int64)
    for j in range(count):
        x = rng.integers(0, hi - j)
        for v in np.sort(out[:, :j], axis=1).T:  # ascending earlier draws
            x = x + (x >= v)
        out[:, j] = x
    return out


def _topic_pools(rng, n_topics: int, n_common: int, per_topic: int, vocab: int) -> np.ndarray:
    """(n_topics, n_common + per_topic) term pools: the global common terms
    0..n_common-1, then a random ordered subset of the rare terms."""
    keys = rng.random((n_topics, vocab - n_common))
    part = np.argpartition(keys, per_topic - 1, axis=1)[:, :per_topic]
    part = np.take_along_axis(part, np.argsort(np.take_along_axis(keys, part, 1), 1), 1)
    common = np.broadcast_to(np.arange(n_common), (n_topics, n_common))
    return np.concatenate([common, n_common + part], axis=1)


def _sample_ell(pools: torch.Tensor, w: torch.Tensor, nnz: int, gen) -> SparseVec:
    """One Zipf-weighted sparse row per pool row, without replacement
    (Gumbel top-k on log weights); values follow the BM25/SPLADE-like
    profile of repro and the ELL row is ordered by value, descending."""
    r, l = pools.shape
    k = min(nnz, l)
    u = torch.rand((r, l), generator=gen, device=pools.device).clamp_(1e-12, 1.0)
    sel = torch.topk(torch.log(w)[None, :] - torch.log(-torch.log(u)), k, dim=1).indices
    val = torch.abs(1.0 + 0.3 * torch.randn((r, k), generator=gen, device=pools.device))
    val = val / torch.sqrt(1.0 + 50.0 * w[sel])
    val, order = torch.sort(val, dim=1, descending=True)
    idx = torch.gather(torch.gather(pools, 1, sel), 1, order)
    if k < nnz:
        pad = torch.full((r, nnz - k), PAD_IDX, dtype=idx.dtype, device=idx.device)
        idx = torch.cat([idx, pad], 1)
        val = torch.cat([val, torch.zeros((r, nnz - k), device=val.device)], 1)
    return SparseVec(idx.to(torch.int32), val.float())


def _ell_rows(rows_idx, rows_val, cap: int):
    """Pack per-row (ids, vals) lists into ELL arrays ordered by value."""
    n = len(rows_idx)
    idx = np.full((n, cap), PAD_IDX, np.int32)
    val = np.zeros((n, cap), np.float32)
    for r, (ii, vv) in enumerate(zip(rows_idx, rows_val)):
        order = np.argsort(-np.asarray(vv), kind="stable")[:cap]
        idx[r, : len(order)] = np.asarray(ii)[order]
        val[r, : len(order)] = np.asarray(vv)[order]
    return idx, val


def make_corpus(cfg: CorpusConfig, device=None) -> SyntheticCorpus:
    """Generate the corpus on ``device`` (``None`` -> CUDA; raises when CUDA
    is absent). Host-side structure (topics, entities, KG, query plans)
    comes from ``numpy.random.default_rng(seed)``, the bulk draws from a
    ``torch.Generator`` seeded alike."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    nt, n = cfg.n_topics, cfg.n_docs

    # --- topic machinery -------------------------------------------------
    centers = _unit(torch.randn((nt, cfg.d_dense), generator=gen, device=dev))
    n_common = max(cfg.terms_per_topic // 2, 8)
    n_common_kw = max(cfg.keywords_per_topic // 2, 4)
    terms = torch.as_tensor(
        _topic_pools(rng, nt, n_common, cfg.terms_per_topic, cfg.vocab_sparse), device=dev)
    kws = torch.as_tensor(
        _topic_pools(rng, nt, n_common_kw, cfg.keywords_per_topic, cfg.vocab_lexical), device=dev)
    w_terms = torch.as_tensor(_zipf(terms.shape[1]), dtype=torch.float32, device=dev)
    w_kws = torch.as_tensor(_zipf(kws.shape[1]), dtype=torch.float32, device=dev)

    # --- documents --------------------------------------------------------
    doc_topics = rng.integers(0, nt, size=n).astype(np.int32)
    topics_d = torch.as_tensor(doc_topics, device=dev).long()
    dense = torch.empty((n, cfg.d_dense), dtype=torch.float32, device=dev)
    s_idx, s_val, f_idx, f_val, commons = [], [], [], [], []
    for s in range(0, n, _ROW_CHUNK):
        t = topics_d[s:s + _ROW_CHUNK]
        noise = torch.randn((len(t), cfg.d_dense), generator=gen, device=dev)
        dense[s:s + len(t)] = _unit(centers[t] + cfg.dense_noise * noise)
        sp = _sample_ell(terms[t], w_terms, cfg.nnz_sparse, gen)
        fp = _sample_ell(kws[t], w_kws, cfg.nnz_lexical, gen)
        s_idx.append(sp.idx)
        s_val.append(sp.val)
        f_idx.append(fp.idx)
        f_val.append(fp.val)
        keys = torch.rand((len(t), cfg.n_common_entities), generator=gen, device=dev)
        commons.append(torch.topk(keys, cfg.entities_per_doc - 1, dim=1).indices.cpu().numpy())
    docs = FusedVectors(
        dense,
        SparseVec(torch.cat(s_idx), torch.cat(s_val)),
        SparseVec(torch.cat(f_idx), torch.cat(f_val)),
    )

    # --- entities + KG chains ---------------------------------------------
    e = cfg.entities_per_doc
    doc_entities = np.full((n, e), PAD_IDX, np.int32)
    doc_entities[:, 0] = np.arange(n)  # rare entity, unique per doc
    n_common_of = rng.integers(0, e, size=n)
    common = n + np.concatenate(commons).astype(np.int32)
    slot = np.arange(e - 1)[None, :] < n_common_of[:, None]
    doc_entities[:, 1:] = np.where(slot, common, PAD_IDX)
    n_chains = max(cfg.n_queries, n // 16)
    chain_docs = _distinct(rng, n, cfg.chain_len, n_chains).astype(np.int32)
    rels = rng.integers(0, 64, size=(n_chains, cfg.chain_len - 1)).astype(np.int32)
    chain_trip = np.stack(
        [chain_docs[:, :-1], rels, chain_docs[:, 1:]], axis=-1).reshape(-1, 3)
    noise_ents = n + _distinct(rng, cfg.n_common_entities, 2, cfg.n_common_entities)
    noise_trip = np.stack(
        [noise_ents[:, 0], rng.integers(0, 64, cfg.n_common_entities), noise_ents[:, 1]], 1)
    kg = KnowledgeGraph(
        np.concatenate([chain_trip, noise_trip]).astype(np.int32), cfg.n_entities)

    # --- queries ------------------------------------------------------------
    q = cfg.n_queries
    r = cfg.relevant_per_query
    qt = rng.integers(0, nt, size=q).astype(np.int32)
    by_topic = np.argsort(doc_topics, kind="stable")
    counts = np.bincount(doc_topics, minlength=nt)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    small = counts[qt] < r  # topics with too few members draw from all docs
    pick = _distinct(rng, np.where(small, n, counts[qt]), r, q)
    q_rel = np.where(small[:, None], pick, by_topic[starts[qt][:, None] + pick]).astype(np.int32)

    rel_d = torch.as_tensor(q_rel, device=dev).long()
    noise = torch.randn((q, cfg.d_dense), generator=gen, device=dev)
    q_dense = _unit(dense[rel_d].mean(1) + 0.5 * cfg.dense_noise * noise)
    rel_s = docs.learned.idx[rel_d].cpu().numpy()  # (Q, R, Ps)
    rel_f = docs.lexical.idx[rel_d].cpu().numpy()
    qsi, qsv, qfi, qfv = [], [], [], []
    q_keywords = np.full((q, 4), PAD_IDX, np.int32)
    for i in range(q):
        pool = np.unique(rel_s[i][rel_s[i] >= 0])
        sel = rng.choice(pool, size=min(cfg.nnz_query_sparse, len(pool)), replace=False)
        qsi.append(sel)
        qsv.append(np.abs(rng.normal(1.0, 0.3, size=len(sel))).astype(np.float32))
        pool = np.unique(rel_f[i][rel_f[i] >= 0])
        sel = rng.choice(pool, size=min(cfg.nnz_query_lexical, len(pool)), replace=False)
        qfi.append(sel)
        qfv.append(np.abs(rng.normal(1.0, 0.3, size=len(sel))).astype(np.float32))
        shared = set(rel_f[i][0][rel_f[i][0] >= 0].tolist())
        for row in rel_f[i][1:]:
            shared &= set(row[row >= 0].tolist())
        if shared:
            q_keywords[i, 0] = sorted(shared)[0]
    chain = rng.integers(0, n_chains, size=q)
    q_entities = np.full((q, 2), PAD_IDX, np.int32)
    q_entities[:, 0] = chain_docs[chain, 0]  # head doc's rare entity
    q_multihop = chain_docs[chain, -1].astype(np.int32)
    qs_idx, qs_val = _ell_rows(qsi, qsv, cfg.nnz_query_sparse)
    qf_idx, qf_val = _ell_rows(qfi, qfv, cfg.nnz_query_lexical)
    t = lambda a: torch.as_tensor(a, device=dev)
    queries = FusedVectors(
        q_dense, SparseVec(t(qs_idx), t(qs_val)), SparseVec(t(qf_idx), t(qf_val)))

    return SyntheticCorpus(
        config=cfg,
        docs=docs,
        doc_entities=doc_entities,
        doc_topics=doc_topics,
        kg=kg,
        queries=queries,
        query_entities=q_entities,
        query_relevant=q_rel,
        query_keywords=q_keywords,
        query_multihop_target=q_multihop,
    )


def recall_at_k(retrieved_ids, truth_ids) -> float:
    """Mean fraction of truth ids present in retrieved ids (per query)."""
    host = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    hits = total = 0
    for r, t in zip(host(retrieved_ids), host(truth_ids)):
        t = t[t >= 0]
        if len(t) == 0:
            continue
        hits += len(set(r.tolist()) & set(t.tolist()))
        total += len(t)
    return hits / max(total, 1)


def ndcg_at_k(retrieved_ids, truth_ids, k: int = 10) -> float:
    """nDCG@k with binary relevance (the paper's accuracy metric)."""
    host = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    scores = []
    for r, t in zip(host(retrieved_ids)[:, :k], host(truth_ids)):
        t = set(t[t >= 0].tolist())
        if not t:
            continue
        dcg = sum(1.0 / np.log2(i + 2) for i, d in enumerate(r.tolist()) if d in t)
        idcg = sum(1.0 / np.log2(i + 2) for i in range(min(len(t), k)))
        scores.append(dcg / idcg)
    return float(np.mean(scores)) if scores else 0.0
