"""Batched serving across architectures: a prefill and decode steps with
caches through one ``ServingEngine`` API, for dense GQA, MLA with MoE, SSM
and hybrid models (port of ``examples/serve_batch.py``). The cache
machinery differs per family; the engine API does not. Each arch runs at
``.reduced()`` size, on the CUDA card unless ``--device`` names another,
with random weights from seed 0 or, with ``--weights DIR``, the ones in
``DIR/<arch>.npz`` (a ``save_tree`` file in the JAX package's flat keys,
as ``repro.checkpointing.save_tree`` writes them).

    PYTHONPATH=src python -m repro_torch.launch.serve_batch [--new-tokens 16]
    PYTHONPATH=src python -m repro_torch.launch.serve_batch --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_batch --device cpu --weights DIR
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpointing import load_tree
from repro_torch.configs import ModelConfig, get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import CausalLM, init, load_jax_params
from repro_torch.models.model import zero_cross_inputs
from repro_torch.serving import ServeConfig, ServingEngine

ARCHS = ["qwen2-0.5b", "deepseek-v2-lite-16b", "falcon-mamba-7b", "recurrentgemma-2b"]


def build_model(cfg: ModelConfig, arch: str, weights: Optional[str],
                device: DeviceLike = None) -> CausalLM:
    """``arch``'s model: the weights in ``weights/<arch>.npz`` when a
    directory is given, else random ones from seed 0."""
    dev = resolve_device(device)
    if weights:
        flat, _ = load_tree(os.path.join(weights, f"{arch}.npz"))
        return load_jax_params(cfg, flat, device=dev)
    return init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def main(argv=None) -> Dict[str, torch.Tensor]:
    """Generates for every arch; returns {arch: (batch, new tokens) int64 on
    the CPU}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--weights", default=None,
                    help="directory of <arch>.npz weights; default: random from seed 0")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    outs = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, arch, args.weights, dev)
        eng = ServingEngine(cfg, model, ServeConfig(max_new_tokens=args.new_tokens), device=dev)
        toks = (torch.arange(args.batch * args.prompt_len, device=dev)
                .reshape(args.batch, args.prompt_len) * 13) % cfg.vocab_size
        batch = {"tokens": toks, **zero_cross_inputs(cfg, args.batch, dev)}
        t0 = time.perf_counter()
        out = eng.generate(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        outs[arch] = out.cpu()
        print(f"{arch:24s} [{cfg.family:6s}] generated {tuple(out.shape)} on {dev} in "
              f"{dt:5.2f}s ({dt / args.new_tokens * 1e3:6.1f} ms/tok, first-use kernel "
              f"builds included)  sample={out[0, :6].tolist()}")
    return outs


if __name__ == "__main__":
    main()
