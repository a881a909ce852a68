"""Training launcher: training on one GPU with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --steps 3 --global-batch 8 --seq-len 512

trains the full-width config on the card with fp32 master weights, bf16
compute, remat and the flash-attention kernels (forward K1, backward K5).
``--smoke`` runs the reduced config; ``--device cpu`` is the only way onto
the CPU (there the kernels' plain versions run); ``--no-kernels`` takes the
einsum attention instead. It restores the latest checkpoint in
``--ckpt-dir`` if there is one and resumes the seekable data stream from
that step.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
from repro_torch.models.layers import resolve_device
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts


def run_training(cfg, *, device=None, steps: int, global_batch: int, seq_len: int,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 microbatches: int = 1, log_every: int = 10, seed: int = 0,
                 remat: bool = True, use_kernels: bool = True,
                 verbose: bool = True,
                 on_step: Optional[Callable] = None):
    """Trains ``steps`` steps (from the latest checkpoint in ``ckpt_dir`` if
    there is one) and returns the losses of the steps run. ``device`` None:
    the card. ``on_step(step, state, metrics)`` is called with
    ``metrics=None`` before the first step and after every step."""
    device = resolve_device(device)
    tcfg = ts.TrainConfig(
        opt=opt_lib.OptimizerConfig(total_steps=max(steps, 10)),
        remat=remat, microbatches=microbatches, use_kernels=use_kernels)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                      global_batch=global_batch, seed=seed))

    step0 = 0
    if ckpt_dir and (latest := ckpt_lib.latest_step(ckpt_dir)) is not None:
        state = ckpt_lib.restore(ckpt_dir, latest, ts.abstract_train_state(cfg, tcfg),
                                 device=device)
        step0 = latest
        if verbose:
            print(f"restored checkpoint at step {latest}")
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        state = ts.init_train_state(cfg, tcfg, gen, device=device)

    if on_step is not None:
        on_step(step0, state, None)
    losses = []
    t0 = time.time()
    for i in range(step0, steps):
        batch = to_device(data.batch(i), device)
        state, metrics = ts.train_step(cfg, tcfg, state, batch)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(i, state, metrics)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} ({time.time() - t0:.1f}s)")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, i + 1, state)
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, state)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on the CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-kernels", action="store_true",
                    help="einsum attention instead of the flash kernels")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    losses = run_training(cfg, device=args.device, steps=args.steps,
                          global_batch=args.global_batch, seq_len=args.seq_len,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          microbatches=args.microbatches, seed=args.seed,
                          remat=not args.no_remat,
                          use_kernels=not args.no_kernels)
    if losses:
        print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
