#!/usr/bin/env python3
"""Served QPS of two or more checkouts on one card, in turns: phase 5 of
each checkout's own ``chip_smoke.py`` (a pool of four 2^18-doc segments and
its int8 twin served through HybridSearchService), then the host time per
call (enqueue only, no sync) of its distance and top-k wrappers at the
served shapes. Served QPS is set by the host's Python round loop, so two
trees are compared only inside one run, alternating.

    python3 examples/torch_serve_compare.py DIR [DIR ...]

Each DIR is the root of a checkout (for example a ``git archive`` of the
parent beside one of the working tree, listed parent, change, parent,
change); each runs in a process of its own. Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def one(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from repro_torch.core.usms import FusedVectors, PathWeights, SparseVec, weighted_query
    from repro_torch.data.corpus import CorpusConfig, make_corpus
    from repro_torch.kernels.fused_topk import fused_topk
    from repro_torch.kernels.hybrid_distance import hybrid_distance

    cs.phase_device()
    full = make_corpus(CorpusConfig(n_docs=cs.N_FULL, n_queries=cs.N_QUERIES, n_topics=1024,
                                    d_dense=1024, seed=0))
    cs.phase_serving(full, {k: {"launches": 0} for k in (
        "hybrid_distance", "fused_topk", "hybrid_distance_int8", "fused_topk_int8")})
    gen = torch.Generator(device="cuda").manual_seed(3)
    seg = full.docs[0:cs.N_SEGMENT]
    q32 = weighted_query(full.queries, PathWeights.three_path())[0:32]
    q96 = FusedVectors(torch.cat([q32.dense] * 3), *(
        SparseVec(torch.cat([s.idx] * 3), torch.cat([s.val] * 3))
        for s in (q32.learned, q32.lexical)))
    ids16 = cs.random_ids(cs.N_SEGMENT, 32, 16, 0.0, gen)
    ids80 = cs.random_ids(cs.N_SEGMENT, 96, 80, 0.3, gen)
    ids24 = cs.random_ids(cs.N_SEGMENT, 32, 24, 0.2, gen)
    bias = torch.rand((32, 24), generator=gen, device="cuda")
    for name, fn in (("hybrid_distance B=32 C=16", lambda: hybrid_distance(q32, seg, ids16)),
                     ("hybrid_distance B=96 C=80", lambda: hybrid_distance(q96, seg, ids80)),
                     ("fused_topk B=32 C=24 k=24", lambda: fused_topk(q32, seg, ids24, 24, bias))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(500):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        print(f"host {name}: {dt / 500 * 1e6:.1f} us a call", flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve())
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for tree in sys.argv[1:]:
        print(f"== {tree}", flush=True)
        res = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                             text=True, timeout=900)
        for ln in res.stdout.splitlines():
            if ln.startswith(("phase 5 serve", "host ")):
                print(ln, flush=True)
        if res.returncode != 0:
            sys.exit(f"{tree}: exit {res.returncode}\n{res.stderr[-3000:]}")


if __name__ == "__main__":
    main()
