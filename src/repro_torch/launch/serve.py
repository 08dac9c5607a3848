"""Serving launcher of the port (``repro/launch/serve.py``): batched
generation with optional hybrid-retrieval augmentation, on the CUDA device
unless ``--device`` says otherwise. It takes no mesh, as ``repro``'s does
not: ``ServingEngine(mesh=)`` is the library's (``serving.engine``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \\
        --requests 16 --prompt-len 16 --gen 32 [--rag] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of
from repro_torch.serving.engine import ServeConfig, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    max_len = args.prompt_len + args.gen + (64 if args.rag else 0)
    eng = ServingEngine(cfg, params, ServeConfig(max_len=max_len, batch=args.requests,
                                                 temperature=args.temperature))
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.requests, args.prompt_len)), dtype=torch.int32,
        device=dev)
    frontend = None
    if cfg.n_frontend_tokens:  # the stub patch / frame embeddings
        frontend = torch.as_tensor(
            rng.normal(0, 0.02, size=(args.requests, cfg.n_frontend_tokens, cfg.d_model)),
            dtype=dtype_of(cfg), device=dev)

    if args.rag:
        from repro_torch.core.build_pipeline import build_index
        from repro_torch.core.index import BuildConfig
        from repro_torch.core.knn_graph import KnnConfig
        from repro_torch.core.pruning import PruneConfig
        from repro_torch.data.corpus import CorpusConfig, make_corpus
        from repro_torch.serving.rag import RagConfig, RagPipeline

        corpus = make_corpus(
            CorpusConfig(n_docs=2048, n_queries=args.requests, d_dense=64, seed=args.seed),
            device=dev)
        index = build_index(
            corpus.docs,
            BuildConfig(knn=KnnConfig(k=16, iters=4), prune=PruneConfig(degree=16)),
            generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev,
        )
        doc_tokens = torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(2048, 16)), dtype=torch.int32, device=dev)
        rag = RagPipeline(eng, index, doc_tokens, RagConfig(top_k=2, ctx_tokens_per_doc=16))
        t0 = time.perf_counter()
        out, res = rag.answer(corpus.queries, prompts, args.gen)
        dt = time.perf_counter() - t0
        print(f"RAG: retrieved top-{res.ids.shape[1]} per request; "
              f"{args.requests} requests in {dt:.2f}s")
        print("sample retrieved ids:", res.ids[0].tolist())
    else:
        t0 = time.perf_counter()
        out = eng.generate(prompts, args.gen, frontend=frontend)
        dt = time.perf_counter() - t0

    tok = args.requests * args.gen
    print(f"generated {tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s) on {dev}")
    print("sample output:", out[0, -16:].tolist())


if __name__ == "__main__":
    main()
