"""The program's spans in the traced slices (``spans.py``) on synthetic
records: kernels credited through their launch to the innermost span, idle
gaps by their midpoint, the three readers of the spans, the gap names, a
record without program spans (a program that records none) read as before,
and the tracer that installs the recorder over the two slices alone."""
import time
from types import SimpleNamespace

import pytest
import torch

from edgebench import costs, harness, metrics, spans, trace
from edgebench.tests.small import small_config, small_mix

QMM = "void qmm_wgmma<128, 128>(CUtensorMap, ...)"
EW = "void at::native::elementwise_kernel<128, 2>(...)"
RED = "void at::native::reduce_kernel<512, 1>(...)"
SPAN_METRICS = ("act_quant_ms", "act_quant_idle_pct", "w4_dequant_ms")

# one infer [0, 1000): the head [10, 500) with a quantization [100, 200) nested
# in it, the link [500, 600) with its own quantization [520, 580), the tail
# [600, 990) with a w4 head's dequantization [700, 800)
PROGRAM = [("serving.infer", 0, 1000, 0), ("split.head", 10, 500, 1), ("quant.act", 100, 200, 2),
           ("split.link", 500, 600, 1), ("quant.act", 520, 580, 2), ("split.tail", 600, 990, 1),
           ("quant.dequant", 700, 800, 2)]
# kernel: its launch
LAUNCHED = {(EW, 150, 170): 110, (RED, 175, 190): 120, (QMM, 210, 400): 200,
            (EW, 520, 530): 500, (EW, 540, 560): 521, (EW, 710, 750): 700,
            (EW, 802, 808): 799, (QMM, 810, 950): 800, (EW, 993, 998): 992}


def _record(cls=spans.Record, batches=None, **kw):
    kernels = sorted(LAUNCHED, key=lambda k: (k[1], k[2]))
    batches = [{"B": 2, "S": 8, "version": "w4"}] if batches is None else batches
    base = dict(config=small_config("starcoder2-3b"), batches=batches, window_s=1e-6,
                kernels=kernels, peaks=costs.peaks(), window=(0, 1000),
                spans=[("edgebench.infer.w4", 0, 1000)],
                host_ops=[("aten::abs", 90, 300), ("cudaLaunchKernel", 700, 702)])
    return cls(**{**base, **kw})


@pytest.fixture
def rec():
    return _record(program=PROGRAM, launch_of=dict(LAUNCHED))


def test_kernels_are_credited_to_the_innermost_span_at_their_launch(rec):
    got = {k: (t, s[0] if s else None) for k, t, s in spans.credited_kernels(rec)}
    assert got == {
        (EW, 150, 170): (110, "quant.act"), (RED, 175, 190): (120, "quant.act"),
        # launched at the quantization's end: its parent's
        (QMM, 210, 400): (200, "split.head"),
        # at the link's start: the link's; a launch at a nested span's start is that span's
        (EW, 520, 530): (500, "split.link"), (EW, 540, 560): (521, "quant.act"),
        # the last instant inside the dequantization, then its end
        (EW, 710, 750): (700, "quant.dequant"), (EW, 802, 808): (799, "quant.dequant"),
        (QMM, 810, 950): (800, "split.tail"),
        # past the tail, still inside the infer
        (EW, 993, 998): (992, "serving.infer")}
    assert spans.kernel_s(rec, "quant.act") == pytest.approx((20 + 15 + 20) * 1e-9)
    assert spans.kernel_s(rec, "quant.dequant") == pytest.approx((40 + 6) * 1e-9)


def test_kernels_without_a_launch_are_credited_to_nothing(rec):
    rec.launch_of.pop((EW, 150, 170))
    assert (EW, 150, 170) not in [k for k, _, _ in spans.credited_kernels(rec)]
    assert spans.kernel_s(rec, "quant.act") == pytest.approx(35e-9)


def test_launches_are_matched_by_correlation_id():
    def ev(name, t0, dur, device, corr):
        return SimpleNamespace(name=lambda: name, start_ns=lambda: t0, duration_ns=lambda: dur,
                               device_type=lambda: device, correlation_id=lambda: corr)
    # torch's ops and the profiler's own records carry ids that can equal a
    # kernel's (as on the card: "Activity Buffer Request" beside a launch)
    events = [ev("aten::abs", 5, 50, "DeviceType.CPU", 7),
              ev("Activity Buffer Request", 9, 1, "DeviceType.CPU", 7),
              ev("cudaLaunchKernel", 10, 3, "DeviceType.CPU", 7),
              ev("Lazy Function Loading", 12, 1, "DeviceType.CPU", 8),
              ev("cuLaunchKernel", 30, 3, "DeviceType.CPU", 8),
              ev(EW, 40, 10, "DeviceType.CUDA", 7),
              ev(QMM, 60, 20, "DeviceType.CUDA", 8),
              ev(RED, 90, 5, "DeviceType.CUDA", 9)]                 # its call not traced
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert spans.launches(prof) == {(EW, 40, 50): 10, (QMM, 60, 80): 30}


def test_idle_gaps_are_credited_by_their_midpoint(rec):
    # idle in the window [0, 1000), at each gap's midpoint: [0, 150) at 75, the
    # head; [170, 175) at 172, the head's quantization; [190, 210) at 200, the
    # head (the quantization ends at 200); [400, 520) at 460, the head; [530,
    # 540) at 535, the link's quantization; [560, 710) at 635, the tail; [750,
    # 802) at 776, the dequantization; [808, 810) and [950, 993), the tail;
    # [998, 1000) at 999, the infer (the tail ends at 990)
    assert spans.idle_by_span(rec) == pytest.approx({
        "split.head": 290e-9, "quant.act": 15e-9, "split.tail": 195e-9,
        "quant.dequant": 52e-9, "serving.infer": 2e-9})
    assert sum(spans.idle_by_span(rec).values()) == pytest.approx(1e-6 - trace.busy_s(rec))
    # outside every program span
    rec.program = [s for s in PROGRAM if s[0] != "serving.infer"]
    assert spans.idle_by_span(rec)[spans.NO_SPAN] == pytest.approx(2e-9)


def test_the_readers_of_the_spans(rec):
    assert metrics.reader("act_quant_ms")(rec) == pytest.approx(1e3 * 55e-9)
    assert metrics.reader("w4_dequant_ms.some-cell")(rec) == pytest.approx(1e3 * 46e-9)
    # the idle in quant.act over the slice's length (the host's, in slice A)
    rec.window, rec.bounds, rec.window_s = None, (0, 1000), 2e-6
    assert metrics.reader("act_quant_idle_pct")(rec) == pytest.approx(100 * 15e-9 / 2e-6)
    rec.batches = [{"B": 1, "S": 4, "version": "w8"}, {"B": 2, "S": 4, "version": "w8"}]
    assert metrics.reader("act_quant_ms")(rec) == pytest.approx(1e3 * 55e-9 / 2)
    assert metrics.reader("w4_dequant_ms")(rec) is None     # no w4 batch in the slice


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_without_program_spans_reads_none(name):
    plain = _record(cls=trace.Record)
    assert metrics.reader(name)(plain) is None
    assert metrics.reader(name)(_record()) is None


@pytest.mark.parametrize("name", ["act_quant_ms", "w4_dequant_ms"])
def test_a_trace_without_runtime_calls_credits_no_kernel(name):
    assert metrics.reader(name)(_record(program=PROGRAM)) is None


def test_existing_readers_read_the_same_with_program_spans():
    plain = _record(cls=trace.Record, batches=[{"B": 2, "S": 8, "version": "w8"}])
    with_spans = _record(batches=plain.batches, program=PROGRAM, launch_of=dict(LAUNCHED))
    names = [m["name"] for m in harness.load_benchmark()["per_layer"]]
    assert names
    for name in names:
        assert metrics.reader(name)(with_spans) == metrics.reader(name)(plain), name


def test_gap_names_keep_the_old_format_without_a_program_span(rec):
    times = [50, 200, 997]
    assert spans.gap_names(_record(), times) == trace.gap_names(_record(), times)
    assert spans.gap_names(rec, times) == ["edgebench.infer.w4: split.head: no host op",
                                           "edgebench.infer.w4: split.head: aten::abs",
                                           "edgebench.infer.w4: serving.infer: no host op"]
    out = spans.breakdown(rec, rec)
    assert out["device_ops"] == trace.breakdown(rec, rec)["device_ops"]
    assert sum(v for _, v in out["idle_gaps"]) == pytest.approx(
        sum(v for _, v in trace.breakdown(rec, rec)["idle_gaps"]))


def test_crediting_checks(rec):
    rec.launch_of[(EW, 520, 530)] = 520      # now the link's quantization's
    got = spans.crediting(rec)
    assert got == {"kernels": 9, "with_launch": 9, "before_launch": 0,
                   "launch_outside_span": 0, "quant.act_calls": 2,
                   "kernels_a_quant.act_call": [2], "infers_off": 0,
                   "kernel_after_launch_us": [0.0, 0.01, 0.055]}
    rec.launch_of[(EW, 150, 170)] = 160      # starts before its launch
    rec.launch_of[(RED, 175, 190)] = 90      # launched before the call
    got = spans.crediting(rec)
    assert (got["before_launch"], got["kernels_a_quant.act_call"], got["infers_off"]) \
        == (1, [1, 2], 1)


def test_batches_of_the_infer_spans():
    evs = [{"type": "span", "name": "serving.infer", "t": 5,
            "attrs": {"version": "w8", "B": 2, "S": 9, "cut": ["main", 1]}},
           {"type": "span", "name": "split.head", "t": 1},
           {"type": "span", "name": "serving.infer", "t": 1,
            "attrs": {"version": "w4", "B": 1, "S": 4, "cut": ["main", 2]}}]
    assert spans.batches_of(evs) == [{"B": 1, "S": 4, "version": "w4"},
                                     {"B": 2, "S": 9, "version": "w8"}]


def test_the_tracer_records_the_two_slices_alone(monkeypatch):
    """A traced run on the CPU with ``spans.Tracer`` in the harness: one
    recorder a slice, each holding that slice's infers, and the null recorder
    back after it (the run then fails: a CPU trace has no device time)."""
    from repro_torch import obs

    made = []

    def tracer(n, device):
        made.append(spans.Tracer(n, device))
        return made[-1]
    monkeypatch.setattr(harness, "Tracer", tracer)
    torch.set_num_threads(2)
    mix = small_mix("split-w8")
    with pytest.raises(RuntimeError, match="no device kernel"):
        harness.run_cell("starcoder2-3b.split-w8", 2 ** 31 + 5, 0.1, True, device="cpu",
                         setup_t0=time.time(), config=small_config("starcoder2-3b"), mix=mix,
                         override=True, log=lambda s: None)
    assert isinstance(obs.get_recorder(), obs.NullRecorder)
    (tr,) = made
    n = mix["round"]
    for r in tr.recorders:
        infers = [e for e in r.events if e["type"] == "span" and e["name"] == "serving.infer"]
        assert len(infers) == n
        assert len([e for e in r.events if e["type"] == "span" and e["name"] == "quant.act"]) > n
    a0, a1 = tr.bounds_a
    first = spans.program_spans(tr.recorders[0])
    assert a0 <= first[0][1] and max(s[2] for s in first) <= a1
