"""Reachability of small segments at full width, the reference against the
port, on the CPU.

chip_smoke.py phase 8 holds every re-inserted doc against one witness no
search computes: is it reached from its segment's entry points along
semantic edges (a breadth-first walk, dead rows included, as a search
expands them)? This script reads that share for graphs the write path
makes, from the same docs (BGE-M3's 1024 dense dims, SPLADE's 30522 vocab,
1024 topics, the default BuildConfig): a fresh build of n docs (a seal or a
merge builds one) and a grow segment born of 64 docs and extended by three
inserts of 64 (the share of each inserted batch right after its insert).
Both packages are read, repro through its plain (non-Pallas) paths, the
port twice: with repro's random draws (the same graph up to ties: its
share beside repro's says whether the port's write path loses nodes the
reference keeps) and with its own generator's. Also the docs with no
in-edge, and the share of its own docs a default dense-only search of the
fresh build returns in its top 10 (the port's).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m tests.segment_reach [n ...]

(default n: 256 512 1024; ~6 min on 4 cores).
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import build_pipeline as rbp
from repro.core.index import BuildConfig as RBuildConfig
from repro.core.knn_graph import KnnConfig as RKnnConfig
from repro.core.pruning import PruneConfig as RPruneConfig
from repro.data.corpus import CorpusConfig, make_corpus
from repro_torch.core import build_pipeline as tbp
from repro_torch.core.fusion import FusionSpec
from repro_torch.core.index import BuildConfig
from repro_torch.core.search import SearchParams, search_padded
from tests.test_torch_build import repro_draws, to_torch
from tests.test_torch_insert import descent_draws

R_CFG = RBuildConfig(knn=RKnnConfig(use_kernel=False), prune=RPruneConfig(use_kernel=False))
GROW, BATCH, INSERTS = 64, 64, 3


def reached(edges: np.ndarray, entries: np.ndarray) -> np.ndarray:
    """(n,) bool: rows a breadth-first walk from ``entries`` along
    ``edges`` (n, d) reaches."""
    n = edges.shape[0]
    seen = np.zeros(n, bool)
    front = np.unique(entries[entries >= 0])
    seen[front] = True
    while front.size:
        nb = edges[front].reshape(-1)
        nb = np.unique(nb[(nb >= 0) & (nb < n)])
        front = nb[~seen[nb]]
        seen[front] = True
    return seen


def no_in_edge(edges: np.ndarray) -> int:
    e = edges[(edges >= 0) & (edges < edges.shape[0])]
    return int((np.bincount(e, minlength=edges.shape[0]) == 0).sum())


def graph(index) -> tuple[np.ndarray, np.ndarray]:
    return np.asarray(index.semantic_edges), np.asarray(index.entry_points)


def self_hit(index, docs) -> float:
    """Share of the index's docs its default dense-only search returns in
    the top 10 for their own vectors (port)."""
    pad = torch.full((docs.n, 1), -1, dtype=torch.int32)
    ids = search_padded(index, docs, FusionSpec.weighted(1.0, 0.0, 0.0), pad, pad,
                        SearchParams(use_keywords=True)).ids.numpy()
    return float(np.mean([i in row for i, row in zip(range(docs.n), ids)]))


def main(sizes: list[int]) -> None:
    torch.set_num_threads(4)
    c = make_corpus(CorpusConfig(n_docs=max(sizes) + GROW + BATCH * INSERTS, n_queries=8,
                                 n_topics=1024, d_dense=1024, seed=0))
    docs = jax.tree.map(jnp.asarray, c.docs)
    tdocs = to_torch(c.docs)
    for n in sizes:
        t = time.perf_counter()
        key = jax.random.key(1)
        r = graph(rbp.build_index(docs[:n], R_CFG, key=key))
        p_index = tbp.build_index(tdocs[0:n], BuildConfig(), draws=repro_draws(n, R_CFG, key),
                                  device="cpu")
        p = graph(p_index)
        o = graph(tbp.build_index(tdocs[0:n], BuildConfig(),
                                  generator=torch.Generator().manual_seed(1), device="cpu"))
        print(f"fresh build of {n}: reached repro {reached(*r).mean():.4f} port "
              f"{reached(*p).mean():.4f} (own draws {reached(*o).mean():.4f}); no in-edge "
              f"repro {no_in_edge(r[0])} port {no_in_edge(p[0])} (own draws "
              f"{no_in_edge(o[0])}); port default dense-only self-hit "
              f"{self_hit(p_index, tdocs[0:n]):.4f} ({time.perf_counter() - t:.1f} s)",
              flush=True)
    lo = max(sizes)
    key = jax.random.key(2)
    rg = rbp.build_index(docs[lo:lo + GROW], R_CFG, key=key)
    pg = tbp.build_index(tdocs[lo:lo + GROW], BuildConfig(), draws=repro_draws(GROW, R_CFG, key),
                         device="cpu")
    for b in range(INSERTS):
        s, key = lo + GROW + BATCH * b, jax.random.key(10 + b)
        rg = rbp.insert(rg, docs[s:s + BATCH], R_CFG, key=key)
        pg = tbp.insert(pg, tdocs[s:s + BATCH], BuildConfig(),
                        draws=descent_draws(BATCH, R_CFG.knn, key))
        new = slice(GROW + BATCH * b, GROW + BATCH * (b + 1))
        print(f"insert {b + 1} of {BATCH} into a grow segment of {GROW + BATCH * b}: the batch "
              f"reached repro {reached(*graph(rg))[new].mean():.4f} port "
              f"{reached(*graph(pg))[new].mean():.4f}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [256, 512, 1024])
