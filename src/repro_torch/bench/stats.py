"""The perf harness's noise model (port of ``repro.bench.stats``).

Timing on a shared host is a heavy-tailed nuisance process: the
scheduler, the allocator and torch's dispatch all inject spikes that a
single ``us_per_call`` number hides. This module owns the whole
measurement story:

- ``timeit(fn, n, reps)``: repeated back-to-back samples with a warmup
  (build-absorbing) call discarded, returning a ``Timing`` — a float
  (min sample, the least-noise headline every format site expects)
  that carries the raw per-repetition samples. Each sample ends with a
  wait for the card (``_block``), so on CUDA it times the kernels, not
  their launches.
- ``reject_outliers``: modified z-score on the MAD — scheduler spikes
  are one-sided and huge, so a robust location estimate is mandatory.
- ``bootstrap_ci``: percentile bootstrap CI for the median
  (deterministic seed — reruns reproduce the stored bounds).
- ``mann_whitney_u``: one-sided nonparametric test (exact for the small
  sample counts benches produce, normal approximation with tie
  correction beyond that) — no distributional assumption on timings.
- ``compare(baseline, current)``: the gate's decision rule. A case
  *regresses* only when the median slowdown exceeds a minimum effect
  threshold AND the Mann-Whitney test calls the shift significant —
  tiny-but-significant jitter (1% on a million samples) passes, and a
  big-but-noisy blip (one 2x sample) passes too.

Every number and decision is the reference's, bit for bit (numpy and
the standard library); torch is touched only by the wait.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from itertools import combinations
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def format_sig(x: float, sig: int = 4) -> float:
    """Round to ``sig`` significant digits (JSON-friendly float) — keeps
    sub-microsecond timings (the distilled-decide target) from
    collapsing to 0.0 the way fixed one-decimal rounding does."""
    x = float(x)
    if x == 0.0 or not math.isfinite(x):
        return x
    return float(f"{x:.{sig}g}")


class Timing(float):
    """us-per-call headline number (min over repetitions — least noise)
    that still *is* a float for every existing format/arithmetic site,
    carrying the per-repetition samples for the JSON records.

    Scaling (``us / 32`` for a per-token number) scales the samples
    too, so derived rows keep their noise model."""

    samples: tuple = ()

    def __new__(cls, value, samples=()):
        t = super().__new__(cls, value)
        t.samples = tuple(float(s) for s in samples) or (float(value),)
        return t

    def __truediv__(self, other):
        return Timing(float(self) / other,
                      [s / other for s in self.samples])

    def __mul__(self, other):
        return Timing(float(self) * other,
                      [s * other for s in self.samples])


def _cuda_devices(out, found: set) -> set:
    """Indices of the CUDA devices holding a tensor in ``out``, walking
    tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device.index)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def _block(out) -> None:
    """Wait for the card: once CUDA is initialized, synchronize the
    current device and every other device that holds a tensor in ``out``
    (so a call that returns ``None`` after launching kernels is waited
    for too). A no-op on the CPU. CUDA errors propagate."""
    if not torch.cuda.is_initialized():
        return
    torch.cuda.synchronize()
    others = _cuda_devices(out, set())
    if others:
        others.discard(torch.cuda.current_device())
        for index in sorted(others):
            torch.cuda.synchronize(index)


def timeit(fn: Callable[[], object], n: int = 5, reps: int = 5,
           warmup: int = 1) -> Timing:
    """``reps`` back-to-back repetitions of an ``n``-call loop, each
    yielding one us-per-call sample, after ``warmup`` discarded calls
    (which absorb the kernels' first-call ``nvcc`` builds); the card is
    waited for after every warmup call and inside each repetition's
    clock, after its ``n`` calls. Returns a ``Timing`` (min sample) whose
    ``.samples`` feed the gate's noise model."""
    for _ in range(max(warmup, 1)):
        _block(fn())
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        _block(out)
        samples.append((time.perf_counter() - t0) / n * 1e6)
    return Timing(min(samples), samples)


# --------------------------------------------------------------------------
# robust summaries
# --------------------------------------------------------------------------

def reject_outliers(samples: Sequence[float], k: float = 3.5
                    ) -> List[float]:
    """Drop samples whose modified z-score (0.6745·|x−med|/MAD) exceeds
    ``k`` — the standard robust cut for one-sided scheduler spikes.
    Fewer than 4 samples pass through untouched (MAD is meaningless)."""
    xs = [float(s) for s in samples]
    if len(xs) < 4:
        return xs
    med = float(np.median(xs))
    mad = float(np.median([abs(x - med) for x in xs]))
    if mad == 0.0:
        # degenerate: most samples identical — fall back to mean abs dev
        mad = float(np.mean([abs(x - med) for x in xs]))
        if mad == 0.0:
            return xs
    return [x for x in xs if 0.6745 * abs(x - med) / mad <= k]


def bootstrap_ci(samples: Sequence[float], alpha: float = 0.05,
                 n_boot: int = 2000, seed: int = 0,
                 stat: Callable = np.median) -> Tuple[float, float]:
    """Percentile-bootstrap (1−alpha) CI for ``stat`` (median). The rng
    is seeded so the bounds written into BENCH history are
    reproducible from the stored samples."""
    xs = np.asarray(samples, dtype=np.float64)
    if xs.size == 0:
        return (float("nan"), float("nan"))
    if xs.size == 1:
        return (float(xs[0]), float(xs[0]))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, xs.size, size=(n_boot, xs.size))
    stats = np.asarray(stat(xs[idx], axis=1))
    lo, hi = np.quantile(stats, [alpha / 2, 1 - alpha / 2])
    return (float(lo), float(hi))


@dataclass(frozen=True)
class SampleStats:
    """Robust summary of one case's samples (post outlier rejection)."""
    n: int              # samples kept
    n_raw: int          # samples collected
    min: float
    median: float
    mean: float
    std: float
    cv: float           # std/mean — the run's own noise estimate
    ci_lo: float        # bootstrap CI of the median
    ci_hi: float


def summarize(samples: Sequence[float], alpha: float = 0.05
              ) -> SampleStats:
    raw = [float(s) for s in samples]
    xs = reject_outliers(raw)
    arr = np.asarray(xs, dtype=np.float64)
    mean = float(arr.mean())
    std = float(arr.std())
    lo, hi = bootstrap_ci(xs, alpha=alpha)
    return SampleStats(n=len(xs), n_raw=len(raw), min=float(arr.min()),
                       median=float(np.median(arr)), mean=mean, std=std,
                       cv=std / mean if mean else 0.0, ci_lo=lo, ci_hi=hi)


# --------------------------------------------------------------------------
# nonparametric comparison (the gate's decision rule)
# --------------------------------------------------------------------------

_EXACT_LIMIT = 30_000   # max C(n+m, m) enumerated for the exact test


def _ranks(values: Sequence[float]) -> np.ndarray:
    """Average ranks (ties shared), 1-based."""
    xs = np.asarray(values, dtype=np.float64)
    order = np.argsort(xs, kind="mergesort")
    ranks = np.empty(xs.size, dtype=np.float64)
    i = 0
    while i < xs.size:
        j = i
        while j + 1 < xs.size and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def mann_whitney_u(a: Sequence[float], b: Sequence[float]) -> float:
    """One-sided Mann-Whitney U: p-value for H1 "``b`` is stochastically
    greater than ``a``" (b slower, for timings). Exact permutation
    distribution when C(n+m, m) is small (the bench regime: a handful
    of samples vs a pooled baseline), normal approximation with tie and
    continuity corrections otherwise."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return 1.0
    ranks = _ranks(list(a) + list(b))
    rb = float(ranks[n:].sum())
    try:
        total = math.comb(n + m, m)
    except OverflowError:       # pragma: no cover
        total = _EXACT_LIMIT + 1
    if total <= _EXACT_LIMIT:
        # exact: fraction of m-subsets of the combined ranks whose rank
        # sum is >= observed (ties handled by the shared average ranks)
        ge = sum(1 for comb in combinations(ranks, m)
                 if sum(comb) >= rb - 1e-12)
        return ge / total
    u = rb - m * (m + 1) / 2.0
    mu = n * m / 2.0
    # tie-corrected variance
    _, counts = np.unique(np.concatenate([np.asarray(a, dtype=np.float64),
                                          np.asarray(b, dtype=np.float64)]),
                          return_counts=True)
    nm = n + m
    tie = float(((counts ** 3 - counts).sum()) / (nm * (nm - 1))) \
        if nm > 1 else 0.0
    var = n * m / 12.0 * (nm + 1 - tie)
    if var <= 0:
        return 1.0
    z = (u - mu - 0.5) / math.sqrt(var)
    return 0.5 * math.erfc(z / math.sqrt(2.0))


@dataclass(frozen=True)
class Comparison:
    """Outcome of one baseline-vs-current case comparison."""
    verdict: str            # ok | regression | improved | insufficient
    effect: float           # median(cur)/median(base) - 1  (+ = slower)
    p_slower: float         # MWU p for "current slower"
    p_faster: float         # MWU p for "current faster"
    base_median: float
    cur_median: float
    n_base: int
    n_cur: int
    cur_ci: Tuple[float, float]   # bootstrap CI of current median
    base_ci: Tuple[float, float]


def compare(baseline: Sequence[float], current: Sequence[float],
            min_effect: float = 0.10, alpha: float = 0.05,
            min_samples: int = 3) -> Comparison:
    """The gate rule. Regression ⇔ median slowdown > ``min_effect`` AND
    one-sided MWU p < ``alpha``; symmetric for improvement. Fewer than
    ``min_samples`` on either side → ``insufficient`` (never fails —
    single-shot benches are reported, not gated)."""
    base = reject_outliers(baseline)
    cur = reject_outliers(current)
    bmed = float(np.median(base)) if base else float("nan")
    cmed = float(np.median(cur)) if cur else float("nan")
    effect = (cmed / bmed - 1.0) if base and cur and bmed > 0 else 0.0
    kw = dict(effect=effect, base_median=bmed, cur_median=cmed,
              n_base=len(base), n_cur=len(cur),
              cur_ci=bootstrap_ci(cur, alpha=alpha),
              base_ci=bootstrap_ci(base, alpha=alpha))
    if len(base) < min_samples or len(cur) < min_samples:
        return Comparison(verdict="insufficient", p_slower=1.0,
                          p_faster=1.0, **kw)
    p_slower = mann_whitney_u(base, cur)
    p_faster = mann_whitney_u(cur, base)
    if effect > min_effect and p_slower < alpha:
        verdict = "regression"
    elif effect < -min_effect and p_faster < alpha:
        verdict = "improved"
    else:
        verdict = "ok"
    return Comparison(verdict=verdict, p_slower=p_slower,
                      p_faster=p_faster, **kw)
