"""EdgeRL split serving (port of ``SplitServingEngine`` in
``repro.serving.engine``).

An EdgeRL controller decision (version j, cut l) routes each request
batch: the chosen version's head runs on the device side, the cut
activation crosses the link (int8 codes + f32 row scales when the version
quantizes activations), the matching tail finishes the logits.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import partition
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import DenseLM
from repro_torch.quant import build_version_params, get_version, quantize_act


class SplitServingEngine:
    """Holds one model per enabled quant version (bf16 / w8 / w4), each
    built on its first ``infer``. ``model`` must already live on
    ``device`` (the CUDA card unless ``device`` names another)."""

    def __init__(self, cfg: ModelConfig, model: DenseLM,
                 versions: Sequence[str] = ("bf16",), device: DeviceLike = None):
        self.device = resolve_device(device)
        where = {p.device for p in model.parameters()}
        if where != {self.device}:
            raise ValueError(f"model lies on {sorted(map(str, where))}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.model = model
        self.versions = tuple(versions)
        for v in self.versions:
            get_version(v)           # validate names up front
        self._vmodels: Dict[str, DenseLM] = {}

    def _model_for(self, version: str) -> DenseLM:
        if version not in self.versions:
            raise KeyError(f"version {version!r} not enabled; have "
                           f"{sorted(self.versions)}")
        if version not in self._vmodels:
            self._vmodels[version] = build_version_params(
                self.cfg, self.model, (version,))[version]
        return self._vmodels[version]

    @torch.inference_mode()
    def infer(self, batch: Dict, cut: Tuple[str, int], version: str = "bf16"):
        """batch: {"tokens": (B, S) ints}. Returns (logits, act_bytes):
        act_bytes is the size of what crosses the device -> server link."""
        model = self._model_for(version)
        batch = {"tokens": torch.as_tensor(batch["tokens"], device=self.device)}
        act = partition.run_head(self.cfg, model, batch, cut)
        if get_version(version).act_bits == 8:
            # the link carries int8 codes + per-row scales, like the w8a8
            # matmuls inside the trunk
            q, s = quantize_act(act)
            act_bytes = q.numel() * q.element_size() + s.numel() * s.element_size()
            act = (q.to(torch.float32) * s).to(act.dtype)
        else:
            act_bytes = act.numel() * act.element_size()
        logits = partition.run_tail(self.cfg, model, act, batch, cut)
        return logits, act_bytes
