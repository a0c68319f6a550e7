"""Pluggable workload generators: per-device request arrival streams
(copy of ``repro.sim.traces``, numpy only).

A trace yields, per decision epoch, the number of requests arriving at
each device during that epoch (``stream``). The fleet loop spreads each
epoch's arrivals uniformly over the slot (exact for a Poisson process
whose rate is constant within the slot, which every generator here is
conditionally on its modulating state).

All randomness flows through the ``numpy.random.Generator`` the caller
passes, so a fixed seed makes the whole simulation bit-reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


class Trace:
    """Base class: a per-device arrival-count process."""

    name = "trace"

    @property
    def mean_rps(self) -> float:
        """Long-run mean arrival rate per device (requests/second);
        used to size epochs and normalize the measured-load feature."""
        raise NotImplementedError

    def stream(self, rng: np.random.Generator, n_devices: int,
               slot_seconds: float) -> Iterator[np.ndarray]:
        """Infinite iterator of per-epoch arrival counts, shape
        (n_devices,), dtype int64."""
        raise NotImplementedError


def presample_counts(trace: Trace, rng: np.random.Generator,
                     n_devices: int, slot_seconds: float,
                     n_requests: int, max_epochs: int) -> np.ndarray:
    """Materialize the epoch stream up front: counts for every epoch
    until cumulative arrivals reach ``n_requests`` (or ``max_epochs``),
    as a (T, n_devices) int64 array.

    Consumes ``rng`` exactly as ``fleet.simulate``'s incremental
    ``next(stream)`` calls would, and applies the identical termination
    rule (stop *after* the epoch that crosses ``n_requests``) — so the
    scan engine sees the same workload, epoch for epoch, as the host
    engines under the same trace seed.
    """
    stream = trace.stream(rng, n_devices, slot_seconds)
    out = []
    served = 0
    while served < n_requests and len(out) < max_epochs:
        counts = np.asarray(next(stream), dtype=np.int64)
        out.append(counts)
        served += int(counts.sum())
    return np.stack(out) if out else np.zeros((0, n_devices), np.int64)


@dataclasses.dataclass
class PoissonTrace(Trace):
    """Homogeneous Poisson arrivals at ``rate_rps`` per device."""
    rate_rps: float = 10.0
    name = "poisson"

    @property
    def mean_rps(self) -> float:
        return self.rate_rps

    def stream(self, rng, n_devices, slot_seconds):
        lam = self.rate_rps * slot_seconds
        while True:
            yield rng.poisson(lam, n_devices)


@dataclasses.dataclass
class MMPPTrace(Trace):
    """2-state Markov-modulated Poisson process (bursty traffic).

    A fleet-wide modulating chain switches between a calm rate and a
    burst rate with per-epoch transition probabilities — the shared
    burst state is what stresses a controller fleet-wide (AutoScale's
    observation: stochastic workload variance is where energy-aware
    controllers win or lose).
    """
    rate_low_rps: float = 2.0
    rate_high_rps: float = 25.0
    p_up: float = 0.15      # calm -> burst per epoch
    p_down: float = 0.35    # burst -> calm per epoch
    name = "mmpp"

    @property
    def mean_rps(self) -> float:
        # stationary distribution of the 2-state chain
        pi_high = self.p_up / max(self.p_up + self.p_down, 1e-12)
        return (1 - pi_high) * self.rate_low_rps + pi_high * self.rate_high_rps

    def stream(self, rng, n_devices, slot_seconds):
        high = False
        while True:
            rate = self.rate_high_rps if high else self.rate_low_rps
            yield rng.poisson(rate * slot_seconds, n_devices)
            p = self.p_down if high else self.p_up
            if rng.random() < p:
                high = not high


@dataclasses.dataclass
class DiurnalTrace(Trace):
    """Sinusoidal day/night rate: base + amplitude * (1 + sin) / 2.

    ``period_epochs`` epochs per simulated day; ``phase`` in [0, 1)
    shifts the peak. Arrivals are Poisson at the instantaneous rate.
    """
    base_rps: float = 4.0
    peak_rps: float = 20.0
    period_epochs: float = 48.0
    phase: float = 0.0
    name = "diurnal"

    @property
    def mean_rps(self) -> float:
        return self.base_rps + (self.peak_rps - self.base_rps) / 2.0

    def rate_rps(self, epoch: int) -> float:
        x = 2.0 * np.pi * (epoch / self.period_epochs + self.phase)
        return self.base_rps + (self.peak_rps - self.base_rps) \
            * (1.0 + np.sin(x)) / 2.0

    def stream(self, rng, n_devices, slot_seconds):
        t = 0
        while True:
            yield rng.poisson(self.rate_rps(t) * slot_seconds, n_devices)
            t += 1


@dataclasses.dataclass
class ReplayTrace(Trace):
    """Replay measured per-epoch arrival counts from an array.

    ``counts`` has shape (epochs,) — broadcast across devices — or
    (epochs, n_devices). The trace cycles when the simulation outruns
    the recording. ``slot_seconds_recorded`` lets ``mean_rps`` report
    the recording's own timescale.
    """
    counts: np.ndarray = None
    slot_seconds_recorded: float = 30.0
    name = "replay"

    def __post_init__(self):
        self.counts = np.atleast_1d(np.asarray(self.counts))
        if self.counts.ndim > 2 or self.counts.size == 0:
            raise ValueError("ReplayTrace needs a non-empty (epochs,) or "
                             "(epochs, n_devices) array")

    @property
    def mean_rps(self) -> float:
        return float(np.mean(self.counts)) / self.slot_seconds_recorded

    def stream(self, rng, n_devices, slot_seconds):
        t = 0
        while True:
            row = self.counts[t % self.counts.shape[0]]
            yield np.broadcast_to(np.atleast_1d(row), (n_devices,)).astype(
                np.int64).copy()
            t += 1


@dataclasses.dataclass
class RandomRateTrace(Trace):
    """Doubly-stochastic Poisson: each epoch and device draws an iid
    rate ~ U(0, max_rps), then Poisson arrivals at that rate.

    Not a realistic workload — it is the *domain randomization* trace:
    training the controller on it covers the whole (load, state) surface
    uniformly, so per-device load sensitivity is learned everywhere
    instead of only at a bursty trace's two modes.
    """
    max_rps: float = 30.0
    name = "uniform"

    @property
    def mean_rps(self) -> float:
        return self.max_rps / 2.0

    def stream(self, rng, n_devices, slot_seconds):
        while True:
            rates = rng.uniform(0.0, self.max_rps, n_devices)
            yield rng.poisson(rates * slot_seconds)


TRACES = {
    "poisson": PoissonTrace,
    "mmpp": MMPPTrace,
    "diurnal": DiurnalTrace,
    "replay": ReplayTrace,
    "uniform": RandomRateTrace,
}


def trace_names() -> tuple:
    return tuple(sorted(TRACES))


def get_trace(name: str, **kw) -> Trace:
    """Canonical-name lookup; a miss names every valid trace (the same
    convention as the policy/scenario/schedule registries)."""
    if name not in TRACES:
        raise KeyError(f"unknown trace {name!r}; valid names: "
                       f"{', '.join(trace_names())}")
    return TRACES[name](**kw)
