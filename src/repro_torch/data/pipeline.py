"""Deterministic synthetic token pipeline with restart-exact skip (the
port's own copy of ``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step): the numpy draws are
``repro``'s, so the tokens equal ``repro``'s bit for bit, and a restarted
job resumes exactly from any checkpoint step without replaying data. The
"corpus" is a Zipf-distributed Markov stream with enough structure that a
small model's loss visibly drops. Batches come back as int32 tensors on the
pipeline's device. The stub modality embeddings (``frontend_tokens > 0``)
come with the vlm and audio families.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32_000
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    n_states: int = 64  # markov states -> learnable structure
    frontend_tokens: int = 0  # >0: also emit stub modality embeddings
    d_model: int = 0


class TokenPipeline:
    """Stateless batch generator: batch(step) is deterministic. ``device``
    (``None`` -> CUDA) is where the batches go."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1, device=None):
        if cfg.frontend_tokens:
            raise NotImplementedError("frontend embeddings come with the vlm and audio "
                                      "families (ROADMAP Queue 1 item 10)")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        # a sparse Markov chain over states; each state emits a Zipf slice
        self._trans = rng.dirichlet(np.ones(cfg.n_states) * 0.1, size=cfg.n_states)
        self._emit_base = rng.integers(0, max(cfg.vocab - 256, 1), size=cfg.n_states)

    def batch(self, step: int) -> dict:
        """{"tokens": (per-host batch, seq_len) int32} of ``step``."""
        cfg = self.cfg
        per_host = cfg.global_batch // self.n_hosts
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 64 + self.host_id)
        states = rng.integers(0, cfg.n_states, size=per_host)
        toks = np.zeros((per_host, cfg.seq_len), np.int32)
        for t in range(cfg.seq_len):
            # vectorized markov step
            u = rng.random(per_host)
            cdf = np.cumsum(self._trans[states], axis=1)
            states = (u[:, None] < cdf).argmax(axis=1)
            offs = rng.zipf(1.5, size=per_host) % 256
            toks[:, t] = (self._emit_base[states] + offs) % cfg.vocab
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
