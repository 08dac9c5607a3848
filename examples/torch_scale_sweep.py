"""How build and search quality of the PyTorch/CUDA port move with corpus
size and NN-Descent rounds, on one GPU.

    python3 examples/torch_scale_sweep.py                      # the default sweep
    python3 examples/torch_scale_sweep.py --points 65536:6 1048576:12

Each point is N:iters (optionally N:iters:dense_noise). The corpus keeps
make_corpus's defaults at d_dense = 1024 with 1024 docs per topic; the build
uses the default BuildConfig with ``knn.iters`` set per point. Prints one JSON
line per point: build seconds, kNN recall@32 of 256 sampled nodes against
brute force, how many distinct ids those 256 lists hold (of 8192 slots; few
means the lists collapsed onto shared hubs), the share of the true
neighbors that share the node's topic, the mean score of the found and of
the true neighbors, and three-path vector recall@10 of 256 queries.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.build_pipeline import build_index  # noqa: E402
from repro_torch.core.fusion import FusionSpec  # noqa: E402
from repro_torch.core.index import BuildConfig  # noqa: E402
from repro_torch.core.search import SearchParams, search  # noqa: E402
from repro_torch.core.usms import weighted_query  # noqa: E402
from repro_torch.data.corpus import CorpusConfig, make_corpus, recall_at_k  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DEFAULT_POINTS = ["8192:6", "65536:6", "262144:2", "262144:6", "1048576:2", "1048576:6",
                  "1048576:12", "1048576:6:0.124"]


def run_point(n: int, iters: int, noise: float) -> dict:
    c = make_corpus(CorpusConfig(n_docs=n, n_queries=256, n_topics=max(n // 1024, 1),
                                 d_dense=1024, dense_noise=noise, seed=0))
    base = BuildConfig()
    cfg = dataclasses.replace(base, knn=dataclasses.replace(base.knn, iters=iters))
    report = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    index = build_index(c.docs, cfg, report=report)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t

    gen = torch.Generator(device="cuda").manual_seed(11)
    sample = torch.randperm(n, generator=gen, device="cuda")[:256]
    scores = ops.pairwise_scores_chunked(c.docs[sample], c.docs, chunk=32768)
    scores[torch.arange(256, device="cuda"), sample] = float("-inf")
    top, truth = torch.sort(scores, dim=1, descending=True, stable=True)
    top, truth = top[:, :32], truth[:, :32]
    knn = report["knn_ids"][sample].long()
    knn_recall = (knn[:, :, None] == truth[:, None, :]).any(-1).float().mean().item()
    topics = torch.as_tensor(c.doc_topics, device="cuda").long()
    same_topic = (topics[truth] == topics[sample][:, None]).float().mean().item()
    knn_scores = torch.gather(scores, 1, knn.clamp(min=0))

    spec = FusionSpec.three_path()
    res = search(index, c.queries, spec, SearchParams())
    top10 = ops.topk_hybrid(weighted_query(c.queries, spec.weights), c.docs, 10, chunk=8192)[1]
    return dict(n=n, iters=iters, dense_noise=noise, build_s=build_s,
                stage_seconds=report["stage_seconds"], knn_recall_at_32=knn_recall,
                knn_distinct_ids=int(torch.unique(knn).numel()),
                truth_same_topic_share=same_topic,
                knn_score_mean=knn_scores.mean().item(), truth_score_mean=top.mean().item(),
                three_path_recall_at_10=recall_at_k(res.ids, top10))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", nargs="+", default=DEFAULT_POINTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scale_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    for p in args.points:
        parts = p.split(":")
        noise = float(parts[2]) if len(parts) > 2 else CorpusConfig.dense_noise
        print(json.dumps(run_point(int(parts[0]), int(parts[1]), noise)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
