"""Batched serving engine (``repro/serving/engine.py``): prefill once per
request batch, then step the decoder over the KV cache (or, for the ssm and
hybrid families, the recurrent state, whose size does not depend on
``max_len``); greedy or temperature sampling; on one device or as one rank
of a device mesh.

With ``mesh`` (``launch.mesh.make_mesh``, axes ``("pod", "data",
"model")``) the engine is SPMD, like the mesh's train step: one process per
device, each calling ``generate`` with the same prompts (and frontend) and
holding its blocks of a model placed as ``training.train_loop.mesh_sharding``
places a train state's parameters (``launch.sharding.place_model``). The
cache is placed by ``cache_shardings``: the rows over the data-parallel axes
where they divide the batch, else on every rank; KV heads, or positions,
or the recurrent states' heads over ``"model"`` (``models.transformer``'s
``cache_specs``). Each rank prefills its rows into its blocks of the cache
(it never builds the whole cache) and decodes them there; the logits are
gathered whole on every rank, which samples the same token: greedy by
``argmax``, temperature from a generator seeded the same on each rank. A
batch the data-parallel ranks split runs the global program over them (the
MoE's capacity is the whole batch's, as ``repro``'s GSPMD program); one
they do not split runs the one-device program on every rank.
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
    batch: int = 8
    temperature: float = 0.0  # 0 -> greedy
    eos_token: int = -1  # -1 -> never stop early (repro's generate never reads it)


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int) -> dict:
    """The decode cache's placement on ``mesh``: a ``NamedSharding`` per leaf
    of ``cache_specs`` at the mesh's data-parallel and model sizes (``repro``'s
    ``cache_shardings``)."""
    from repro_torch.launch.sharding import NamedSharding

    specs = tfm.mesh_cache_specs(cfg, mesh, batch, max_len)
    return {g: {k: NamedSharding(mesh, s) for k, s in tree.items()} for g, tree in specs.items()}


class ServingEngine:
    """Single-model engine; drives prefill once per request batch and then
    steps the decoder, on the device its parameters lie on or, with
    ``mesh``, as this rank of it (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params: tfm.Transformer, scfg: ServeConfig,
                 mesh=None):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.launch.sharding import check_world
            from repro_torch.training.train_loop import mesh_sharding

            check_world(mesh)
            placement = getattr(params, "placement", None)
            if placement is None or placement.mesh is not mesh or (
                    placement.specs != mesh_sharding(cfg, mesh).specs):
                raise ValueError("the model is not placed on this mesh as mesh_sharding places "
                                 "it: place it with launch.sharding.place_model(model, "
                                 "train_loop.mesh_sharding(cfg, mesh))")
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
        phases. On a mesh every rank passes the same arguments and gets the
        same tokens."""
        dev = self.params.device
        prompts = prompts.to(dev, torch.int32)
        b, lp = prompts.shape
        if lp + n_tokens > self.scfg.max_len:
            raise ValueError(f"{lp} prompt + {n_tokens} new tokens exceed max_len "
                             f"{self.scfg.max_len}")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if frontend is not None:
            frontend = frontend.to(dev)
        rows, whole, on_mesh = self._placement(b)
        t0 = time.perf_counter()
        with on_mesh():
            logits, cache = self._prefill(self.params, rows(prompts),
                                          None if frontend is None else rows(frontend))
            toks = [prompts]
            cur = self._sample(whole(logits), generator)
            if trace is not None:
                self._sync()
                t1 = time.perf_counter()
                trace.add_span("prefill", t0, t1, batch=b, tokens=b * lp)
            for i in range(n_tokens):
                toks.append(cur[:, None])
                if i == n_tokens - 1:
                    break
                logits, cache = self._decode(self.params, rows(cur), cache, lp + i)
                cur = self._sample(whole(logits), generator)
        out = torch.cat(toks, dim=1)
        if trace is not None:
            self._sync()
            trace.add_span("decode", t1, time.perf_counter(), batch=b,
                           steps=max(n_tokens - 1, 0))
        return out

    def _placement(self, b: int):
        """(the rank's rows of a batch tensor, the whole logits from the
        rank's, the model context) for a batch of ``b``."""
        import contextlib

        if self.mesh is None:
            same = lambda t: t  # noqa: E731
            return same, same, contextlib.nullcontext
        from repro_torch.launch.mesh import axis_group, mesh_dp_size
        from repro_torch.launch.sharding import all_gather, dp_block
        from repro_torch.training.train_loop import dp_axes_of, mesh_model

        mesh, dp = self.mesh, mesh_dp_size(self.mesh)
        split = b % dp == 0 and b >= dp  # cache_specs' rule for the batch entry
        specs = tfm.mesh_cache_specs(self.cfg, mesh, b, self.scfg.max_len)
        ag = axis_group(mesh, ("pod", "data"))
        if split:
            rows = lambda t: dp_block(t, mesh, dp_axes_of(mesh))  # noqa: E731
            whole = lambda t: all_gather(t, ag, mesh, 0)  # noqa: E731
        else:
            rows = whole = lambda t: t  # noqa: E731
        return rows, whole, lambda: mesh_model(self.params, mesh, global_dp=split,
                                               cache_specs=specs)
