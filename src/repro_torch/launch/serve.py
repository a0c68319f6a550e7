"""Serving launcher: batched generation through the ServingEngine (port of
``repro.launch.serve``). Runs on the CUDA card unless ``--device`` names
another; random weights from seed 0. The cross-attention families get zero
media (llama-3.2-vision-90b) or zero frames (whisper-large-v3), as the
reference feeds them.

    PYTHONPATH=src python -m repro_torch.launch.serve --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --full
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import init
from repro_torch.models.model import zero_cross_inputs
from repro_torch.serving import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(cfg, model, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature), device=dev)
    toks = (torch.arange(args.batch * args.prompt_len, device=dev)
            .reshape(args.batch, args.prompt_len) * 101) % cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    batch = {"tokens": toks, **zero_cross_inputs(cfg, args.batch, dev)}
    out = eng.generate(batch, generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} on {dev} in {dt:.2f}s "
          f"({dt / args.new_tokens * 1e3:.1f} ms/token, first-use kernel builds included)")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()
