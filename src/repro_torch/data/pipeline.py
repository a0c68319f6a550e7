"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Token streams come from a seeded Zipf-ish unigram plus Markov bigram
mixture, drawn from numpy's PCG64 exactly as the JAX package draws them, so
a batch of the same (seed, step) is the reference's bit for bit. The
structure is enough for a language model's loss to fall. Batches are the
dicts the models take ({tokens, targets, [media | enc_frames]}), as numpy
arrays; ``to_device`` puts them on a torch device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    vocab_zipf_a: float = 1.2
    markov_states: int = 64    # bigram structure the model can learn


class SyntheticLMDataset:
    """Seeded infinite stream of (tokens, targets) with learnable structure."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        rng = np.random.default_rng(data.seed)
        V = cfg.vocab_size
        m = min(data.markov_states, V)
        # sparse bigram transition table over m "hub" tokens
        self._hubs = rng.choice(V, size=m, replace=False)
        self._next = rng.integers(0, m, size=(m, 4))
        ranks = np.arange(1, V + 1, dtype=np.float64)
        probs = ranks ** (-data.vocab_zipf_a)
        self._probs = probs / probs.sum()
        # what Generator.choice(V, p=probs) computes on every call: the
        # normalised cdf, searched with one uniform draw (side="right")
        cdf = self._probs.cumsum()
        self._cdf = cdf / cdf[-1]

    def _sample_stream(self, rng: np.random.Generator, n: int) -> np.ndarray:
        m = len(self._hubs)
        out = np.empty(n, dtype=np.int64)
        state = rng.integers(0, m)
        for i in range(n):
            if rng.random() < 0.75:
                state = self._next[state, rng.integers(0, 4)]
                out[i] = self._hubs[state]
            else:
                out[i] = self._cdf.searchsorted(rng.random(), side="right")
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        d = self.data
        rng = np.random.default_rng((self.data.seed, step))
        toks = np.stack([self._sample_stream(rng, d.seq_len + 1)
                         for _ in range(d.batch_size)])
        b = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
        if self.cfg.cross_attn_every:
            b["media"] = rng.standard_normal(
                (d.batch_size, self.cfg.n_media_tokens,
                 self.cfg.d_model)).astype(np.float32)
        if self.cfg.enc_dec:
            b["enc_frames"] = rng.standard_normal(
                (d.batch_size, self.cfg.encoder_seq,
                 self.cfg.d_model)).astype(np.float32)
        return b


def to_device(batch: Dict[str, np.ndarray], device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (default: the current CUDA
    card), dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def make_train_iterator(cfg: ModelConfig, data: DataConfig,
                        device: DeviceLike = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of steps 0, 1, ... on ``device``."""
    ds = SyntheticLMDataset(cfg, data)
    step = 0
    while True:
        yield to_device(ds.batch(step), device)
        step += 1
