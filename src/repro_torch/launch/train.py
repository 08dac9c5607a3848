"""Training launcher of the port (``repro/launch/train.py``), on the CUDA
device unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 200 --batch 8 --seq 512 --ckpt-dir /tmp/run1 [--smoke] [--device cpu]

One device: the mesh that ``repro`` builds from the device count comes with
the multi-GPU slice. Fault tolerance: checkpoint every ``--ckpt-every``
steps, automatic restart from the last commit, deterministic data skip,
straggler monitoring.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.runtime.fault_tolerance import StragglerMonitor, run_supervised
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainConfig, make_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        opt=opt.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    pipe = TokenPipeline(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed),
        device=dev,
    )
    step_fn = make_train_step(cfg, tcfg, None, None)

    def make_state():
        return make_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(args.seed),
                                dev)

    n_params = cfg.n_params if not args.smoke else sum(
        p.numel() for p in make_state()["params"].parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps} device={dev}")

    if args.ckpt_dir:
        report = run_supervised(
            n_steps=args.steps, make_state=make_state, train_step=step_fn,
            batch_fn=pipe.batch, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, monitor=StragglerMonitor(),
        )
        print(f"done: {report.steps_done} steps, {report.restarts} restarts, "
              f"final loss {report.losses[-1]:.4f}")
        return

    state = make_state()
    t0 = time.perf_counter()
    for s in range(args.steps):
        state, metrics = step_fn(state, pipe.batch(s))
        if s % args.log_every == 0 or s == args.steps - 1:
            dt = time.perf_counter() - t0
            tok_s = args.batch * args.seq * (s + 1) / dt
            print(f"step {s:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                  f"tok/s {tok_s:,.0f}", flush=True)


if __name__ == "__main__":
    main()
