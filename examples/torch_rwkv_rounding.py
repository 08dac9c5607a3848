"""How far fp32 rounding alone moves rwkv6's first-step gradients, on the
CPU:

    PYTHONPATH=src python examples/torch_rwkv_rounding.py [--seed 0]

One training step of rwkv6-7b's smoke config at fp32 on one device
(parameters drawn by the port from seed 3, an 8 x 32 batch of tokens from
``--seed``), taken three ways: as it is; with every product of the time
mix's ``wo`` and the channel mix's ``wv`` summed from two halves of its
inner dim, as a model axis of 2 sums them on a mesh; and in float64 (the
port's model functions with ``dtype_of`` and ``Tensor.float()`` kept at
float64). For each pair it prints the largest |difference| of a leaf's
gradient relative to that leaf's largest |gradient|, and the leaves where it
is largest. The mesh step's first moment (0.1 of the gradient) is held
against the one-device step's in tests/test_torch_lm_mesh.py by that
measure.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.convert import model_params_from_numpy, model_params_to_numpy  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, make_train_step  # noqa: E402
from tests import torch_dist_ranks as ranks  # noqa: E402


def gradients(cfg, tree, batch, f64: bool = False) -> dict:
    """{name: the first step's gradient (float64 copy)}."""
    model = model_params_from_numpy(cfg, tree, "cpu")
    if f64:
        for p in model.parameters():
            p.data = p.data.double()
    ocfg = opt.OptConfig(**ranks.LM_OPT)
    state = {"params": model, "opt": opt.init_opt_state(dict(model.named_parameters()), ocfg)}
    got, update = {}, opt.adamw_update

    def read(grads, *args):
        got.update({k: g.detach().double().clone() for k, g in grads.items()})
        return update(grads, *args)

    train_loop.opt.adamw_update = read
    try:
        make_train_step(cfg, TrainConfig(opt=ocfg))(state, batch)
    finally:
        train_loop.opt.adamw_update = update
    return got


def split_row_products(cfg):
    """``x @ w`` summed from two halves of the inner dim for every
    (d or hidden, d) weight of the blocks (``wo``, the channel mix's ``wv``),
    as ``reduce_from`` sums a model axis of 2's partial products."""
    inner = (cfg.d_model, int(cfg.d_model * 3.5))
    matmul = torch.Tensor.__matmul__

    def split(x, w):
        if w.dim() == 2 and w.shape[0] in inner and w.shape[1] == cfg.d_model:
            h = w.shape[0] // 2
            return matmul(x[..., :h], w[:h]) + matmul(x[..., h:], w[h:])
        return matmul(x, w)

    return matmul, split


def report(label: str, got: dict, want: dict) -> None:
    gaps = sorted(((float((got[k] - w).abs().max() / w.abs().max()), k) for k, w in want.items()),
                  reverse=True)
    print(f"{label}: largest {gaps[0][0]:.3e}; " + ", ".join(f"{k} {g:.3e}" for g, k in gaps[:4]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cfg, _ = ranks.lm_config("rwkv")
    tree = model_params_to_numpy(tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (ranks.LM_BATCH, ranks.LM_SEQ),
                                                    dtype=np.int32))}
    plain = gradients(cfg, tree, batch)
    matmul, split = split_row_products(cfg)
    torch.Tensor.__matmul__ = split
    try:
        halves = gradients(cfg, tree, batch)
    finally:
        torch.Tensor.__matmul__ = matmul
    with ranks.float64_compute():
        exact = gradients(cfg, tree, batch, f64=True)
    report("fp32, row products in two halves, against fp32", halves, plain)
    report("fp32 against float64", plain, exact)
    report("fp32, row products in two halves, against float64", halves, exact)
    return 0


if __name__ == "__main__":
    sys.exit(main())
