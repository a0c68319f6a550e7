"""Continuous-batching scheduler (port of ``repro.serving.scheduler``):
slot-based request admission over a fixed decode batch, the serving pattern
real inference frameworks (vLLM/JetStream) use: requests arrive
asynchronously, prefill on admission, decode in lockstep, retire on
EOS/max-tokens, refill the freed slot.

Because ``decode_step`` takes one shared host ``pos``, slots decode in
*cohorts* that share a position (cohort = requests admitted together,
left-padded to the longest prompt). Requests retire *individually*: a
finished request is compacted out of its cohort (a gather on the batch axis
of every cache leaf), the freed slot re-admits queued work on the next loop
turn, and a cohort whose ring cache is exhausted retires truncated instead
of letting ``pos`` wrap over live history.

The cross-attention families get zero media or zero frames for each
admitted cohort, as the reference feeds them; compaction gathers their
cross caches with the rings, by ``cache_axes``.

Per-request accounting matches the ``sim.metrics`` schema: submit ->
first-token (TTFT) and submit -> done wall steps, summarized by
``ServerStats.latency_summary``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import check_model_device
from repro_torch.sim.metrics import summarize_latencies


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt (S,)
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    truncated: bool = False       # ring cache ran out before EOS/max
    submit_step: int = -1         # wall step at submit()
    first_token_step: int = -1    # wall step of prefill (first token)
    done_step: int = -1           # wall step at retirement

    @property
    def done(self) -> bool:
        if self.truncated:
            return True
        if self.eos_id is not None and self.out and self.out[-1] == self.eos_id:
            return True
        return len(self.out) >= self.max_new_tokens


@dataclasses.dataclass
class ServerStats:
    admitted: int = 0
    completed: int = 0
    decode_steps: int = 0
    prefills: int = 0
    truncated: int = 0
    wall_steps: int = 0           # scheduler loop turns
    slot_reclaims: int = 0        # slots freed by individual retirement
    ttft_steps: List[int] = dataclasses.field(default_factory=list)
    e2e_steps: List[int] = dataclasses.field(default_factory=list)

    def latency_summary(self, slo_steps: Optional[float] = None) -> Dict:
        """Same schema as the fleet simulator's latency reports
        (``sim.metrics.summarize_latencies``), in wall-step units."""
        out = summarize_latencies(self.e2e_steps, slo=slo_steps,
                                  duration=float(self.wall_steps) or None,
                                  unit="steps")
        ttft = summarize_latencies(self.ttft_steps, unit="steps")
        out["ttft_p50"] = ttft["p50"]
        out["ttft_p95"] = ttft["p95"]
        out["ttft_mean"] = ttft["mean"]
        return out


def _map2(fn, tree, axes):
    """fn(leaf, axes leaf) over two dict trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], axes[k]) for k in tree}
    return fn(tree, axes)


class ContinuousBatchingServer:
    """Cohort-based continuous batching over ``prefill``/``decode_step``.
    ``model`` must already live on ``device`` (the CUDA card unless
    ``device`` names another)."""

    def __init__(self, cfg: ModelConfig, model: M.CausalLM, *, max_batch: int = 4,
                 cache_len: int = 256, device: DeviceLike = None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.queue: Deque[Request] = deque()
        self.stats = ServerStats()
        self._cache_axes = M.cache_axes(cfg)
        # cohorts: list of dicts {requests, cache, tok, pos}
        self._cohorts: List[Dict] = []

    # -- client API ---------------------------------------------------------

    def submit(self, req: Request):
        if len(req.tokens) + 1 > self.cache_len:
            raise ValueError(
                f"prompt of {len(req.tokens)} tokens cannot fit a "
                f"cache_len={self.cache_len} ring with one generated token")
        req.submit_step = self.stats.wall_steps
        self.queue.append(req)

    @torch.inference_mode()
    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive admission + decode until queue and cohorts drain."""
        finished: List[Request] = []
        steps = 0
        while (self.queue or self._cohorts) and steps < max_steps:
            self.stats.wall_steps += 1
            self._admit()
            finished.extend(self._step_all())
            steps += 1
        return finished

    # -- internals ----------------------------------------------------------

    def _slots_in_use(self) -> int:
        return sum(len(c["requests"]) for c in self._cohorts)

    def _admit(self):
        free = self.max_batch - self._slots_in_use()
        admit: List[Request] = []
        # cohort = requests admitted together (left-pad to max prompt len)
        while self.queue and len(admit) < free:
            admit.append(self.queue.popleft())
        if not admit:
            return
        S = max(len(r.tokens) for r in admit)
        toks = np.zeros((len(admit), S), np.int64)
        for i, r in enumerate(admit):
            toks[i, S - len(r.tokens):] = r.tokens   # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 **M.zero_cross_inputs(self.cfg, len(admit), self.device)}
        logits, cache = M.prefill(self.cfg, self.model, batch,
                                  total_len=self.cache_len)
        first = torch.argmax(logits, dim=-1)
        for r, t in zip(admit, first.tolist()):
            r.out.append(t)
            r.first_token_step = self.stats.wall_steps
        self._cohorts.append({"requests": admit, "cache": cache,
                              "tok": first, "pos": S})
        self.stats.admitted += len(admit)
        self.stats.prefills += 1

    def _take_slots(self, cache, idx: torch.Tensor):
        """Gather cohort cache slots along each leaf's batch axis."""
        return _map2(lambda a, ax: a.index_select(ax.index("batch"), idx),
                     cache, self._cache_axes)

    def _retire(self, c, finished: List[Request]) -> bool:
        """Retire finished requests individually, compacting the cohort
        so their slots free up for re-admission. Returns True while the
        cohort still has live requests."""
        live = [i for i, r in enumerate(c["requests"]) if not r.done]
        if len(live) == len(c["requests"]):
            return True
        for r in c["requests"]:
            if r.done:
                r.done_step = self.stats.wall_steps
                self.stats.completed += 1
                self.stats.truncated += int(r.truncated)
                self.stats.ttft_steps.append(
                    r.first_token_step - r.submit_step)
                self.stats.e2e_steps.append(r.done_step - r.submit_step)
                finished.append(r)
        if not live:
            return False
        self.stats.slot_reclaims += len(c["requests"]) - len(live)
        idx = torch.tensor(live, device=self.device)
        c["requests"] = [c["requests"][i] for i in live]
        c["cache"] = self._take_slots(c["cache"], idx)
        c["tok"] = c["tok"][idx]
        return True

    def _step_all(self) -> List[Request]:
        finished: List[Request] = []
        keep = []
        for c in self._cohorts:
            if not self._retire(c, finished):
                continue
            if c["pos"] >= self.cache_len:
                # ring cache exhausted: retire truncated rather than let
                # decode positions wrap over live history
                for r in c["requests"]:
                    r.truncated = True
                self._retire(c, finished)
                continue
            logits, cache = M.decode_step(self.cfg, self.model, c["cache"],
                                          c["tok"], c["pos"])
            nxt = torch.argmax(logits, dim=-1)
            for r, t in zip(c["requests"], nxt.tolist()):
                r.out.append(t)
            c.update(cache=cache, tok=nxt, pos=c["pos"] + 1)
            self.stats.decode_steps += 1
            keep.append(c)
        self._cohorts = keep
        return finished
