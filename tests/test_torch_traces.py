"""repro_torch's workload traces, trace-driven task sampler and fleet
metrics against repro's on the CPU: the same numpy seeds must give the
same arrays, value for value."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.sim import metrics as ref_metrics  # noqa: E402
from repro.sim import traces as ref_traces  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.sim import metrics, traces  # noqa: E402

# one instance of each trace kind, built with the same kwargs in both
# packages (the replay recording is (epochs, devices) here)
TRACE_KW = {
    "poisson": {"rate_rps": 7.5},
    "mmpp": {"rate_low_rps": 2.0, "rate_high_rps": 30.0},
    "diurnal": {"base_rps": 2.0, "peak_rps": 30.0, "period_epochs": 12.0, "phase": 0.3},
    "replay": {"counts": np.arange(15).reshape(5, 3) % 4, "slot_seconds_recorded": 10.0},
    "uniform": {"max_rps": 30.0},
}


def _pair(name):
    kw = TRACE_KW[name]
    return ref_traces.get_trace(name, **kw), traces.get_trace(name, **kw)


def test_trace_registry_matches_the_reference():
    assert traces.trace_names() == ref_traces.trace_names() == tuple(sorted(TRACE_KW))
    with pytest.raises(KeyError) as e:
        traces.get_trace("no-such-trace")
    for name in traces.trace_names():
        assert name in str(e.value)


@pytest.mark.parametrize("name", sorted(TRACE_KW))
def test_trace_streams_equal_the_reference(name):
    """60 epochs of per-device counts from one seed, and the mean rate."""
    ref, port = _pair(name)
    assert port.mean_rps == ref.mean_rps
    a = ref.stream(np.random.default_rng(4), 3, 10.0)
    b = port.stream(np.random.default_rng(4), 3, 10.0)
    for _ in range(60):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("name", ["mmpp", "uniform"])
def test_presample_counts_equal_the_reference(name):
    ref, port = _pair(name)
    for n_requests, max_epochs in ((5000, 1000), (10 ** 9, 40)):
        x = ref_traces.presample_counts(ref, np.random.default_rng(1), 4, 10.0,
                                        n_requests, max_epochs)
        y = traces.presample_counts(port, np.random.default_rng(1), 4, 10.0,
                                    n_requests, max_epochs)
        assert y.dtype == np.int64
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("name", ["uniform", "mmpp"])
def test_task_sampler_equals_the_reference(name):
    """``make_task_sampler``'s offered-load sequences (numpy PCG64 per
    SeedSequence([seed, episode])), episode for episode."""
    ref_cfg, ref_tables = R.make_paper_env(n_uavs=4, peak_rps=30.0)
    cfg, tables = T.make_paper_env(n_uavs=4, peak_rps=30.0, device="cpu")
    ref, port = _pair(name)
    ref_s = R.make_task_sampler(ref_cfg, ref, seed=3)
    port_s = T.make_task_sampler(cfg, port, seed=3)
    for ep in (0, 1, 17):
        x, y = ref_s(ep), port_s(ep)
        assert y.shape == (cfg.episode_len, cfg.n_uavs) and y.dtype == np.float32
        np.testing.assert_array_equal(y, x)
    assert T.make_task_sampler(cfg, None, 0) is None
    cfg0, _ = T.make_paper_env(device="cpu")        # peak_rps 0: no normalization
    with pytest.raises(ValueError, match="peak_rps"):
        T.make_task_sampler(cfg0, port, 0)


def _record_both(slo_s, batches, drops):
    ref, port = ref_metrics.FleetMetrics(slo_s=slo_s), metrics.FleetMetrics(slo_s=slo_s)
    for lat, en, dev in batches:
        ref.record(lat, en, device=dev)
        port.record(lat, en, device=dev)
    for n in drops:
        ref.drop(n)
        port.drop(n)
    return ref, port


def test_fleet_metrics_equal_the_reference():
    """Per-device batches (scalar device ids, as the loop engine records)
    and per-request id arrays (the vectorized engine's), drops, the
    epoch-slicing marks, and the summaries with and without a duration."""
    r = np.random.default_rng(0)
    batches = [(r.exponential(0.8, c), r.uniform(0.0, 2.0, c), d)
               for d, c in ((0, 5), (1, 0), (2, 40))]
    batches.append((r.exponential(0.8, 30), np.full(30, 0.25), np.repeat([0, 1, 3], 10)))
    ref, port = _record_both(1.0, batches, (3, 0, 7))
    for duration in (None, 120.0):
        assert port.summary(duration) == ref.summary(duration)
    for attr in ("latencies_s", "energies_j", "devices"):
        x, y = getattr(ref, attr), getattr(port, attr)
        assert y.dtype == x.dtype
        np.testing.assert_array_equal(y, x)
    mark = port.mark()
    assert mark == ref.mark()
    for m in (ref, port):
        m.record([0.5, 3.0], [1.0, 1.0], device=1)
    for x, y in zip(ref.since(mark), port.since(mark)):
        np.testing.assert_array_equal(y, x)
    empty = metrics.FleetMetrics(slo_s=2.0)
    assert str(empty.summary()) == str(ref_metrics.FleetMetrics(slo_s=2.0).summary())


@pytest.mark.parametrize("stride,cap", [(1, None), (3, None), (2, 4)])
def test_epoch_log_equals_the_reference(stride, cap):
    """Row appends and bulk column extends under stride and cap: the
    columns, the dict rows, slicing, length and the held final row."""
    ref, port = ref_metrics.EpochLog(stride, cap), metrics.EpochLog(stride, cap)
    r = np.random.default_rng(stride)
    for e in range(11):
        row = {"epoch": e, "arrivals": int(r.integers(0, 50)),
               "queue_jobs": float(r.uniform(0, 9)), "dropped": 0, "regime": 0}
        ref.append(row)
        port.append(row)
    assert len(port) == len(ref) and repr(port) == repr(ref)
    assert list(port) == list(ref) and port[1:3] == ref[1:3] and port[-1] == ref[-1]
    cols = {"epoch": np.arange(11, 18), "arrivals": np.arange(7) * 3,
            "queue_jobs": np.linspace(0, 1, 7), "dropped": np.zeros(7, np.int64),
            "regime": np.zeros(7, np.int64)}
    ref.extend_columns(**cols)
    port.extend_columns(**cols)
    for k, x in ref.columns.items():
        assert port.columns[k].dtype == x.dtype
        np.testing.assert_array_equal(port.columns[k], x)
    with pytest.raises(ValueError):
        metrics.EpochLog(stride=0)
