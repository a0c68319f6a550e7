"""Training launcher (port of ``repro.launch.train``): AdamW steps of an LM
on the synthetic pipeline, on the CUDA card unless ``--device`` names
another. Random weights from ``torch.Generator`` seed 0; each step runs
under an ``obs`` span ``train.step``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 50 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 8 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import obs
from repro_torch.checkpointing import save_checkpoint
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLMDataset, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init, param_tree
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--quiet", action="store_true",
                    help="warnings only on the console")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)
    if args.quiet:
        obs.set_verbosity(0)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    obs.info(f"arch={args.arch} reduced={args.reduced} params={n_params:,} device={dev}")
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    opt_state = adamw_init(param_tree(model))
    step_fn = make_train_step(cfg, opt, remat=cfg.train_remat,
                              microbatches=args.microbatches)
    ds = SyntheticLMDataset(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq))
    t0, m = time.time(), {}
    for i in range(args.steps):
        batch = to_device(ds.batch(i), dev)
        with obs.span("train.step", step=i):
            model, opt_state, m = step_fn(model, opt_state, batch)
        if (i + 1) % max(args.steps // 10, 1) == 0:
            obs.info(f"step {i+1:4d} loss={float(m['loss']):.4f} "
                     f"gnorm={float(m['grad_norm']):.2f}")
    obs.info(f"{args.steps} steps in {time.time()-t0:.1f}s")
    if args.ckpt_dir:
        obs.info("checkpoint: " + save_checkpoint(args.ckpt_dir, args.steps,
                                                  param_tree(model)))
    return model, m


if __name__ == "__main__":
    main()
