"""End-to-end LM training (the counterpart of the JAX package's
``examples/train_lm.py``): a qwen2-family LM on the synthetic deterministic
pipeline with AdamW, its cosine schedule and step checkpoints, resumed from
the latest checkpoint in ``--ckpt-dir`` when there is one. Runs on the CUDA
card unless ``--device`` names another; asserts that the loss went down.

``--size small`` (default) is the quick 460,416-parameter model; ``--size
100m`` the ~124M-parameter one, sized for the card.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 120 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_lm --size 100m --steps 300
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpointing import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import assign_params, init, param_tree
from repro_torch.optim import AdamWConfig, adamw_init


def build_cfg(size: str):
    base = get_config("qwen2-0.5b")
    if size == "100m":
        return base.with_overrides(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab_size=50_304, tie_embeddings=False)
    return base.reduced().with_overrides(n_layers=2, d_model=128, d_ff=256,
                                         vocab_size=512)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="small", choices=["small", "100m"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_cfg(args.size)
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} variant={args.size} params={n_params:,} device={dev}")
    opt = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                      weight_decay=0.01)
    opt_state = adamw_init(param_tree(model))
    step_fn = make_train_step(cfg, opt, remat=False)

    start = 0
    if (s := latest_step(args.ckpt_dir)) is not None:
        assign_params(model, restore_checkpoint(args.ckpt_dir, s, param_tree(model)))
        start = s
        print(f"resumed from checkpoint step {s}")

    ds = SyntheticLMDataset(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq))
    t0, first_loss, m = time.time(), None, None
    for i in range(start, args.steps):
        model, opt_state, m = step_fn(model, opt_state, to_device(ds.batch(i), dev))
        if first_loss is None:
            first_loss = float(m["loss"])
        if (i + 1) % 10 == 0:
            print(f"step {i+1:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f}", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, i + 1, param_tree(model))
            print(f"  checkpoint -> {path}")
    if m is None:
        print(f"nothing to do: the checkpoint at step {start} reaches --steps {args.steps}")
        return model, None, None
    dt = time.time() - t0
    final = float(m["loss"])
    print(f"\ndone: {args.steps - start} steps in {dt:.1f}s "
          f"({dt/(args.steps-start+1e-9):.2f}s/step); "
          f"loss {first_loss:.3f} -> {final:.3f}")
    assert final < first_loss, "loss did not decrease"
    return model, first_loss, final


if __name__ == "__main__":
    main()
