"""How the gap between rwkv6's two scan forms grows over the layers of
rwkv6-7b at full width, in the reference and in the port, on the CPU.

chip_smoke.py phase 11 reads rwkv6-7b's chunked scan against its per-step
recurrence. At fp32, block outputs agree to ~1e-6 of their size, yet the
logits of the two forms part by several units. This script tells a model's
own amplification of rounding from a fault of the port that compounds over
the layers: it runs the first ``--layers`` blocks of rwkv6-7b (d_model 4096,
64 WKV heads of 64, fp32, repro's random init from a seed, the port given
the same weights) on embedding-scale inputs (N(0, 0.02), as repro draws the
token table) and prints, per layer and per package,

- ``own``: the chunked block against the per-step block on the same input
  (the per-step stream's), max |difference| / max |output|: what gate (a)
  reads;
- ``carried``: the chunked stream against the per-step stream, each fed its
  own previous output, max |difference| / max |output|, and its growth over
  the layer before;
- ``port - repro``: the port's per-step block against repro's on repro's
  per-step stream, max |difference| / max |output|.

If repro's ``carried`` grows from layer to layer as the port's does, while
``port - repro`` stays at rounding, the growth is the random-init model's,
not the port's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m tests.rwkv6_drift [--layers 4] [--len 256]

(not collected by pytest; ~2 GB and ~1-2 min a layer at L 256 on 4 cores).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as r_config
from repro.models import rwkv6 as rrwkv
from repro_torch.configs import get_config as t_config
from repro_torch.models import rwkv6 as trwkv


def _leaf(tree, name: str):
    node = tree
    for key in name.split("."):
        node = node[key]
    return node


def _port_block(cfg, tree) -> trwkv.RWKV6Block:
    """The port's block holding repro's block parameters ``tree``."""
    blk = trwkv.RWKV6Block(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.tensor(np.asarray(_leaf(tree, name), np.float32)))
    return blk


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--len", type=int, default=256, help="tokens, a multiple of ssm_chunk")
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rcfg = dataclasses.replace(r_config("rwkv6-7b"), dtype="float32")
    tcfg = dataclasses.replace(t_config("rwkv6-7b"), dtype="float32")
    assert args.len % rcfg.ssm_chunk == 0 and args.len > 1, "--len must take the chunked form"
    b, l, d = args.rows, args.len, rcfg.d_model
    print(f"rwkv6-7b, fp32, first {args.layers} of {rcfg.n_layers} layers, d_model {d}, "
          f"{d // rcfg.ssm_head_dim} WKV heads of {rcfg.ssm_head_dim}, ssm_chunk "
          f"{rcfg.ssm_chunk}, {b} x {l} tokens, seed {args.seed}", flush=True)
    x0 = (0.02 * np.random.default_rng(args.seed).standard_normal((b, l, d))).astype(np.float32)
    r_zero = {k: jnp.zeros(s.shape, s.dtype) for k, s in rrwkv.rwkv6_state_shape(rcfg, b).items()}
    t_zero = lambda: {k: torch.zeros(s.shape, dtype=s.dtype)
                      for k, s in trwkv.rwkv6_state_shape(tcfg, b).items()}
    r_step = r_chunk = jnp.asarray(x0)
    t_step = t_chunk = torch.from_numpy(x0)
    prev = {"repro": None, "port": None}
    keys = jax.random.split(jax.random.key(args.seed), args.layers)
    for i in range(args.layers):
        t = time.perf_counter()
        tree = jax.tree.map(np.asarray, rrwkv.init_rwkv6_block(keys[i], rcfg))
        blk = _port_block(tcfg, tree)
        r_apply = lambda x, chunked: rrwkv.apply_rwkv6_block(tree, rcfg, x, r_zero,
                                                             chunked=chunked)[0]
        with torch.no_grad():
            t_apply = lambda x, chunked: trwkv.apply_rwkv6_block(blk, tcfg, x, t_zero(),
                                                                 chunked=chunked)[0]
            r_next_step = r_apply(r_step, False)
            r_own = _rel(r_apply(r_step, True), r_next_step)
            r_next_chunk = r_apply(r_chunk, True)
            t_next_step = t_apply(t_step, False)
            t_own = _rel(t_apply(t_step, True), t_next_step)
            t_next_chunk = t_apply(t_chunk, True)
            port_repro = _rel(t_apply(torch.tensor(np.asarray(r_step)), False), r_next_step)
        r_step, r_chunk, t_step, t_chunk = r_next_step, r_next_chunk, t_next_step, t_next_chunk
        carried = {"repro": _rel(r_chunk, r_step), "port": _rel(t_chunk, t_step)}
        growth = {k: "" if prev[k] is None else f" ({v / prev[k]:.3g}x)"
                  for k, v in carried.items()}
        print(f"layer {i}: own repro {r_own:.3g} port {t_own:.3g}; carried repro "
              f"{carried['repro']:.3g}{growth['repro']} port {carried['port']:.3g}"
              f"{growth['port']}; port - repro (per-step) {port_repro:.3g}; max |out| "
              f"{float(np.abs(np.asarray(r_step)).max()):.4g}; {time.perf_counter() - t:.1f} s",
              flush=True)
        prev = carried
        del tree, blk


if __name__ == "__main__":
    main()
