"""Dev loop: for every arch at ``.reduced()`` size, the training loss, a
prefill and a decode step, each finite, and the prefill's caches shaped as
``init_cache`` builds them (port of ``scripts/dev_smoke.py``). On the CUDA
card unless ``--device`` names another; random weights from seed 0, or
with ``--weights DIR`` the ones in ``DIR/<arch>.npz`` (the JAX package's
``save_tree`` keys).

    PYTHONPATH=src python -m repro_torch.launch.dev_smoke [ARCH ...]
    PYTHONPATH=src python -m repro_torch.launch.dev_smoke --device cpu qwen2-0.5b
"""
from __future__ import annotations

import argparse
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve_batch import build_model
from repro_torch.models import decode_step, forward_train, init_cache, n_params, prefill


def batch_for(cfg, B=2, S=16, rng=None) -> Dict[str, np.ndarray]:
    """The reference's batch, drawn from the same numpy stream: tokens and
    targets, and random media or frames for the cross-attention
    families."""
    rng = rng or np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    b["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.cross_attn_every:
        b["media"] = rng.normal(size=(B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["enc_frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _shapes(tree, prefix=""):
    """{path: shape} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tuple(tree.shape)}


@torch.no_grad()
def main(argv=None) -> Dict[str, Dict]:
    """Checks every arch named (default: all ten); returns {arch: {"loss",
    "prefill_tokens", "decode_tokens"}}, the tokens the greedy argmax of
    the prefill's and the decode step's logits, on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", help=f"archs to check; default: all of {ALL_ARCHS}")
    ap.add_argument("--weights", default=None,
                    help="directory of <arch>.npz weights; default: random from seed 0")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    out = {}
    for name in args.archs or ALL_ARCHS:
        cfg = get_config(name).reduced()
        model = build_model(cfg, name, args.weights, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch_for(cfg).items()}
        b["tokens"], b["targets"] = b["tokens"].long(), b["targets"].long()
        B, S = b["tokens"].shape
        loss, _ = forward_train(cfg, model, b, remat=False)
        assert math.isfinite(float(loss)), (name, loss)
        logits, cache = prefill(cfg, model, {k: v for k, v in b.items() if k != "targets"})
        assert torch.isfinite(logits).all(), name
        tok = torch.argmax(logits, -1)
        logits2, cache = decode_step(cfg, model, cache, tok, S)
        assert torch.isfinite(logits2).all(), name
        # a cache built from scratch has the prefill's structure and shapes
        got, want = _shapes(cache), _shapes(init_cache(cfg, B, S, device=dev))
        assert got == want, (name, got, want)
        out[name] = {"loss": float(loss), "prefill_tokens": tok.cpu(),
                     "decode_tokens": torch.argmax(logits2, -1).cpu()}
        print(f"OK {name:24s} params={n_params(cfg):,} loss={float(loss):.3f}")
    return out


if __name__ == "__main__":
    main()
