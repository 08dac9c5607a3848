"""Batched serving engine (``repro/serving/engine.py:18-75``): prefill once
per request batch, then step the decoder over the KV cache (or, for the ssm
and hybrid families, the recurrent state, whose size does not depend on
``max_len``); greedy or temperature sampling. The mesh shardings
(``cache_shardings``, ``ServingEngine(mesh=)``) come with the serving half
of the mesh slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.obs.tracer import TraceContext


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024
    temperature: float = 0.0  # 0 -> greedy


class ServingEngine:
    """Single-model engine on the device its parameters lie on."""

    def __init__(self, cfg: ModelConfig, params: tfm.Transformer, scfg: ServeConfig):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self._prefill = tfm.make_prefill(cfg, scfg.max_len)
        self._decode = tfm.make_decode_step(cfg)

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Greedy: ``torch.argmax``, whose ties go to the first index as
        ``jnp.argmax``'s do. Temperature: ``torch.multinomial`` over the
        tempered softmax (no parity with ``jax.random``'s draws)."""
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    def _sync(self) -> None:
        if self.params.device.type == "cuda":
            torch.cuda.synchronize(self.params.device)

    @torch.inference_mode()
    def generate(
        self,
        prompts: torch.Tensor,  # (B, Lp) int
        n_tokens: int,
        *,
        frontend: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        trace: Optional[TraceContext] = None,
    ) -> torch.Tensor:
        """Teacher-free generation. Returns (B, Lp + n_tokens) int32.
        ``frontend`` (B, n_frontend_tokens, d_model): the vlm's patch or the
        audio family's frame embeddings, which the prefill turns into the
        fixed cross-attention cache. ``generator`` (on the parameters'
        device) drives temperature sampling; it defaults to seed 0. With
        ``trace``, the device is synchronised after prefill and after the
        last step, and the spans ``prefill`` and ``decode`` record the two
        phases."""
        dev = self.params.device
        prompts = prompts.to(dev, torch.int32)
        b, lp = prompts.shape
        if lp + n_tokens > self.scfg.max_len:
            raise ValueError(f"{lp} prompt + {n_tokens} new tokens exceed max_len "
                             f"{self.scfg.max_len}")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        if frontend is not None:
            frontend = frontend.to(dev)
        logits, cache = self._prefill(self.params, prompts, frontend)
        toks = [prompts]
        cur = self._sample(logits, generator)
        if trace is not None:
            self._sync()
            t1 = time.perf_counter()
            trace.add_span("prefill", t0, t1, batch=b, tokens=b * lp)
        for i in range(n_tokens):
            toks.append(cur[:, None])
            if i == n_tokens - 1:
                break
            logits, cache = self._decode(self.params, cur, cache, lp + i)
            cur = self._sample(logits, generator)
        out = torch.cat(toks, dim=1)
        if trace is not None:
            self._sync()
            trace.add_span("decode", t1, time.perf_counter(), batch=b,
                           steps=max(n_tokens - 1, 0))
        return out
