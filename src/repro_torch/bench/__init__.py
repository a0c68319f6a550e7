"""repro_torch.bench: variance-aware perf harness with regression gating
(port of ``repro.bench``).

The perf trajectory is an observable: benchmarks declare a case matrix
(``matrix``), the runner executes it under ``repro_torch.obs``
recording with per-case phase breakdowns (``runner``), timings carry
repeated samples with a robust noise model (``stats``), every run
appends fingerprint-stamped rows to a history file (``history``), and
the gate (``gate`` + ``python -m repro_torch.launch.benchgate``) fails
on statistically significant regressions, naming the regressed obs
*phase*, not just the case.

On the card every sample, and every case's ``bench`` span, ends with a
wait for the device (``stats._block``): torch on CUDA returns before its
kernels finish, so without it the harness would time launches.

    from repro_torch.bench import Matrix, emit, run, timeit

    m = Matrix()
    m.add(my_case)          # my_case() calls emit(name, timeit(fn), "")
    res = run(m.cases())    # res.records: samples, CI, phases
    # gate vs history (and append this run)
    python -m repro_torch.launch.benchgate results.json \\
        --history history.jsonl
"""
from repro_torch.bench.gate import (CaseVerdict, GateReport, attribute_phase,
                                    gate_records, render)
from repro_torch.bench.history import (Baseline, append, baseline_for,
                                       fingerprint, fp_key, git_sha, load,
                                       stamp)
from repro_torch.bench.matrix import Case, Matrix
from repro_torch.bench.runner import RunResult, Sink, emit, fold_phases, run
from repro_torch.bench.stats import (Comparison, SampleStats, Timing,
                                     bootstrap_ci, compare, format_sig,
                                     mann_whitney_u, reject_outliers,
                                     summarize, timeit)

__all__ = [
    "Matrix", "Case",
    "Timing", "timeit", "SampleStats", "summarize", "reject_outliers",
    "bootstrap_ci", "mann_whitney_u", "compare", "Comparison",
    "format_sig",
    "Sink", "emit", "run", "RunResult", "fold_phases",
    "fingerprint", "fp_key", "git_sha", "append", "load", "stamp",
    "baseline_for", "Baseline",
    "gate_records", "GateReport", "CaseVerdict", "attribute_phase",
    "render",
]
