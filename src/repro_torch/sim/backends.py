"""Request-pricing backends behind one interface (port of
``repro.sim.backends``).

``AnalyticalBackend`` prices every request through the single cost core
(``repro_torch.core.pricing``) with ``xp=numpy`` over numpy table
snapshots: the formulas the env rewards with under torch, at fleet scale
on the host. The tables are copied from their device once.

``ExecuteBackend`` extends it: a sampled subset of requests is routed
through the real ``SplitServingEngine``, so the simulated activation
bytes can be cross-checked *exactly* against the measured ones, and the
analytical latency model can be checked for consistency against
wall-clock execution (calibrated on the first sample; ratios thereafter
must stay within a stated tolerance). The expected cost it checks
against comes from the same PricingBreakdown the fleet prices with.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pricing
from repro_torch.core.env import EnvConfig, ProfileTables
from repro_torch.core.pricing import PricingBreakdown, StateView
from repro_torch.models.model import zero_cross_inputs


class AnalyticalBackend:
    """Prices (version, cut) actions from the dense env tables."""

    def __init__(self, env_cfg: EnvConfig, tables: ProfileTables):
        self.env_cfg = env_cfg
        self.tables = tables
        # numpy snapshots: indexing dense tables per epoch must not pay a
        # device round trip on the hot path
        self._np_tables = pricing.numpy_tables(tables)

    def price(self, model_id: np.ndarray, actions: np.ndarray,
              bandwidth: np.ndarray, p_tx: np.ndarray, *,
              srv_flops=None, srv_service_s=None, link_scale=None,
              link_rtt_s=None) -> PricingBreakdown:
        """One pricing core, numpy namespace. The view carries queue=0
        (the fleet loop adds its own *measured* server wait per epoch)
        and load=0 (the stability score is a training-time signal).
        Cluster runs pass the pool's live per-server service arrays and
        the topology's link matrices; actions then carry a server column
        and the core reprices Eq. 2-4 against each chosen target."""
        view = StateView(
            model_id=np.asarray(model_id),
            bandwidth=np.asarray(bandwidth, dtype=np.float64),
            p_tx=np.asarray(p_tx, dtype=np.float64),
            queue=0.0, load=0.0,
            srv_flops=srv_flops, srv_service_s=srv_service_s,
            link_scale=link_scale, link_rtt_s=link_rtt_s)
        return pricing.price_actions(self.env_cfg, self._np_tables,
                                     view, np.asarray(actions), xp=np)

    # the analytical backend executes nothing; the fleet loop calls this
    # hook unconditionally so both backends share one interface
    def maybe_execute(self, model_idx: int, j: int, k: int) -> None:
        return None

    def cross_check(self) -> Optional[Dict]:
        return None


class ExecuteBackend(AnalyticalBackend):
    """Analytical pricing + sampled execution through SplitServingEngine.

    ``model_cfgs``/``profiles`` must be the configs and the ModelProfiles
    the env tables were built from, and ``seq_len`` the profile sequence
    length: the executed batch is (1, seq_len) so the measured cut
    activation is byte-identical to the table entry. Each of ``engines``
    is a ``SplitServingEngine`` serving that config's model, with every
    version of its profile, on its device (the port's counterpart of the
    reference's params: one engine builds each version's model once).
    """

    def __init__(self, env_cfg: EnvConfig, tables: ProfileTables,
                 model_cfgs: Sequence, profiles: Sequence,
                 engines: Sequence, *, seq_len: int, sample: int = 16,
                 latency_tolerance: float = 5.0):
        super().__init__(env_cfg, tables)
        self.model_cfgs = list(model_cfgs)
        self.profiles = list(profiles)
        self.seq_len = int(seq_len)
        self.sample = int(sample)
        self.latency_tolerance = float(latency_tolerance)
        self.records: List[Dict] = []
        self._calib_speedup: Optional[float] = None
        self._engines = list(engines)
        # one batch a model, on its engine's device once
        self._batches = [self._make_batch(c, e.device)
                         for c, e in zip(self.model_cfgs, self._engines)]

    def _make_batch(self, cfg, device):
        """One (1, seq_len) request; the cross-attention families' zero media
        or zero frames beside it, as the reference feeds them."""
        toks = (torch.arange(self.seq_len, dtype=torch.int64, device=device)[None] * 7) \
            % cfg.vocab_size
        return {"tokens": toks, **zero_cross_inputs(cfg, 1, device)}

    def expected_act_bytes(self, model_idx: int, j: int, k: int,
                           batch: int = 1) -> int:
        """Wire bytes the engine must measure for this action: the table
        entry scaled by batch, plus the f32 per-row scales the w8a8 link
        format carries (engine.infer ships int8 codes + scales; the env
        tables price codes only)."""
        from repro_torch.quant import get_version

        prof = self.profiles[model_idx]
        v = prof.versions[min(j, len(prof.versions) - 1)]
        base = int(self._np_tables.cut_bytes[model_idx, j, k]) * batch
        if get_version(v.version).act_bits == 8:
            base += batch * self.seq_len * 4
        return base

    def maybe_execute(self, model_idx: int, j: int, k: int) -> None:
        """Route one request through the real split engine (up to
        ``sample`` total) and record measured vs analytical cost.

        Terminal cuts (profile layer == n_layers) are skipped: the env
        prices them as device-complete inference shipping a class id,
        while the executable engine always finishes logits server-side,
        so nothing crosses the link for the tables to agree with."""
        if len(self.records) >= self.sample:
            return
        from repro_torch.core.controller import resolve_selection

        cfg = self.model_cfgs[model_idx]
        prof = self.profiles[model_idx]
        v = prof.versions[min(j, len(prof.versions) - 1)]
        if v.cut_points[min(k, len(v.cut_points) - 1)] >= v.n_layers:
            return
        version, cut = resolve_selection(cfg, prof, int(j), int(k))
        eng = self._engines[model_idx]
        batch = self._batches[model_idx]

        def sync():
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)

        eng.infer(batch, cut, version)      # warm (builds the kernels at first use)
        sync()
        t0 = time.perf_counter()
        logits, measured_bytes = eng.infer(batch, cut, version)
        sync()
        wall_s = time.perf_counter() - t0
        # expected compute time from the same PricingBreakdown the fleet
        # prices with: head + tail model-seconds for this (j, k); the
        # engine runs both halves on this host, so no link/queue terms
        br = self.price(np.asarray([model_idx]), np.asarray([[j, k]]),
                        np.asarray([1.0]), np.asarray([0.0]))
        model_s = float(br.head_s[0] + br.tail_s[0])
        if self._calib_speedup is None:
            # the first sample calibrates this host's speed relative to
            # the modeled regime; later samples then test the analytical
            # model's *relative* cost structure against real execution
            self._calib_speedup = model_s / max(wall_s, 1e-9)
        est_s = model_s / self._calib_speedup
        self.records.append({
            "model": cfg.name, "version": version, "cut": cut,
            "j": int(j), "k": int(k),
            "expected_bytes": self.expected_act_bytes(model_idx, j, k),
            "measured_bytes": int(measured_bytes),
            "logits_finite": bool(torch.isfinite(logits).all()),
            "wall_s": wall_s, "est_s": est_s,
        })

    def cross_check(self) -> Optional[Dict]:
        if not self.records:
            return None
        mismatches = [r for r in self.records
                      if r["expected_bytes"] != r["measured_bytes"]]
        ratios = np.array([r["wall_s"] / max(r["est_s"], 1e-12)
                           for r in self.records])
        tol = self.latency_tolerance
        return {
            "samples": len(self.records),
            "bytes_exact": not mismatches,
            "bytes_mismatches": len(mismatches),
            "latency_ratio_median": float(np.median(ratios)),
            "latency_ratio_max": float(np.max(ratios)),
            "latency_tolerance": tol,
            "latency_within_tolerance": bool(
                np.all((ratios >= 1.0 / tol) & (ratios <= tol))),
            "records": self.records,
        }
