"""Batched serving (port of ``repro.serving.engine``).

``ServingEngine`` is the plain path: prefill builds the caches (attention
rings, or Mamba conv and scan states), then one decode step per token,
greedy or sampled with temperature.

``SplitServingEngine`` is EdgeRL split serving: a controller decision
(version j, cut l) routes each request batch: the chosen version's head
runs on the device side, the cut activation crosses the link (int8 codes +
f32 row scales when the version quantizes activations), the matching tail
finishes the logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core import partition
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models.model import CausalLM
from repro_torch.quant import build_version_params, get_version, quantize_act


def check_model_device(model: CausalLM, device: torch.device) -> None:
    """Raise unless every parameter of ``model`` lies on ``device``."""
    where = {p.device for p in model.parameters()}
    if where != {device}:
        raise ValueError(f"model lies on {sorted(map(str, where))}, "
                         f"the engine on {device}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0    # 0 => greedy
    cache_len: Optional[int] = None


class ServingEngine:
    """Prefill + token-by-token decode over the model's caches. ``model``
    must already live on ``device`` (the CUDA card unless ``device`` names
    another)."""

    def __init__(self, cfg: ModelConfig, model: CausalLM,
                 serve: ServeConfig = ServeConfig(), device: DeviceLike = None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.cfg = cfg
        self.model = model
        self.serve = serve

    @torch.inference_mode()
    def generate(self, batch: Dict,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch: {"tokens": (B, S) ints, and "media" or "enc_frames" for
        the cross-attention families} -> (B, max_new_tokens) int64 on the
        engine's device. The prefill reads the media or frames; the decode
        steps read the cross caches it built.

        Token 0 is the argmax of the prefill logits, as in the reference;
        each later token comes from one decode step, so N tokens take N - 1
        steps (the reference's scan runs N and drops the last token). With
        ``temperature > 0`` the tokens after the first are drawn from
        softmax(logits / temperature) with ``generator`` (on the engine's
        device); torch's draws are not ``jax.random.categorical``'s, so
        sampled tokens differ from the reference's while greedy ones agree."""
        serve = self.serve
        batch = M.batch_on(batch, self.device)
        S = batch["tokens"].shape[1]
        total = serve.cache_len if serve.cache_len is not None else S + serve.max_new_tokens
        logits, cache = M.prefill(self.cfg, self.model, batch, total_len=total)
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        for pos in range(S, S + serve.max_new_tokens - 1):
            logits, cache = M.decode_step(self.cfg, self.model, cache, tok, pos)
            if serve.temperature > 0:
                probs = torch.softmax(logits.float() / serve.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        return torch.stack(out, dim=1)


class SplitServingEngine:
    """Holds one model per enabled quant version (bf16 / w8 / w4), each
    built on its first ``infer``. ``model`` must already live on
    ``device`` (the CUDA card unless ``device`` names another)."""

    def __init__(self, cfg: ModelConfig, model: CausalLM,
                 versions: Sequence[str] = ("bf16",), device: DeviceLike = None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.cfg = cfg
        self.model = model
        self.versions = tuple(versions)
        for v in self.versions:
            get_version(v)           # validate names up front
        self._vmodels: Dict[str, CausalLM] = {}

    def _model_for(self, version: str) -> CausalLM:
        if version not in self.versions:
            raise KeyError(f"version {version!r} not enabled; have "
                           f"{sorted(self.versions)}")
        if version not in self._vmodels:
            with obs.span("serving.build_version", version=version):
                self._vmodels[version] = build_version_params(
                    self.cfg, self.model, (version,))[version]
        return self._vmodels[version]

    @torch.inference_mode()
    def infer(self, batch: Dict, cut: Tuple[str, int], version: str = "bf16"):
        """batch: {"tokens": (B, S) ints, and "media" or "enc_frames" for
        the cross-attention families, which both sides read}. Returns
        (logits, act_bytes): act_bytes is the size of what crosses the
        device -> server link.

        Spans (``repro_torch.obs``, no-ops unless a recorder is installed):
        ``serving.infer`` around the whole call, with ``split.head``,
        ``split.link`` and ``split.tail`` inside it."""
        B, S = batch["tokens"].shape[:2]
        with obs.span("serving.infer", version=version, B=B, S=S, cut=cut):
            model = self._model_for(version)
            batch = M.batch_on(batch, self.device)
            with obs.span("split.head"):
                act = partition.run_head(self.cfg, model, batch, cut)
            with obs.span("split.link"):
                if get_version(version).act_bits == 8:
                    # the link carries int8 codes + per-row scales, like the
                    # w8a8 matmuls inside the trunk
                    q, s = quantize_act(act)
                    act_bytes = q.numel() * q.element_size() + s.numel() * s.element_size()
                    act = (q.to(torch.float32) * s).to(act.dtype)
                else:
                    act_bytes = act.numel() * act.element_size()
            with obs.span("split.tail"):
                logits = partition.run_tail(self.cfg, model, act, batch, cut)
        return logits, act_bytes
