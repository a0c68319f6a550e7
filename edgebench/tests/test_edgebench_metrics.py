"""Each per-layer metric reader on a small synthetic profiler record, and the
traced slice's reduction (a CPU-only trace holds no device time and fails)."""
import json

import pytest
import torch

from edgebench import costs, harness, metrics, trace
from edgebench.costs import flash_attention as fa
from edgebench.costs import mamba_scan as ms
from edgebench.costs import quant_matmul as qmm
from edgebench.tests.small import small_config

FA = "void flash_fwd<float, 128, 128>(float const*, ...)"
QMM = "void qmm_wgmma<128, 128>(CUtensorMap, ...)"
SCAN = "void mamba_scan<4>(float const*, ...)"
SCAN_BWD = "void mamba_scan_bwd<4>(float const*, ...)"
EW = "void at::native::elementwise_kernel<128, 2>(...)"


def _rec(config, batches, kernels, window=(0, 1000)):
    spans = [("edgebench.infer.w8", 0, 600), ("edgebench.infer.w8", 650, 1000)]
    host = [("aten::mm", 0, 150), ("aten::abs", 550, 700)]
    return trace.Record(config, batches, (window[1] - window[0]) * 1e-9, kernels, costs.peaks(),
                        window, spans, host)


def read(name, rec):
    return metrics.reader(name)(rec)


@pytest.fixture
def dense():
    config = small_config("starcoder2-3b")
    batches = [{"B": 2, "S": 8, "version": "w8"}, {"B": 1, "S": 4, "version": "w8"}]
    kernels = [(FA, 100, 200), (QMM, 300, 400), (EW, 350, 500), (FA, 800, 900)]
    return _rec(config, batches, kernels)


def test_device_idle_pct(dense):
    # busy: [100, 200] and [300, 500] and [800, 900] = 400 of 1000 ns
    assert read("device_idle_pct", dense) == pytest.approx(60.0)


def test_kernels_per_batch(dense):
    assert read("kernels_per_batch", dense) == pytest.approx(2.0)


def test_split_mfu_pct(dense):
    from edgebench.costs import infer
    p = costs.peaks()
    ideal = infer.ideal_s(dense.config, 2, 8, "w8", p) + infer.ideal_s(dense.config, 1, 4, "w8", p)
    assert read("split_mfu_pct", dense) == pytest.approx(100 * ideal / 1e-6)


def test_flash_attention_roofline_pct(dense):
    m, p = dense.config["model"], costs.peaks()
    L = m["n_layers"]
    bound = sum(L * fa.bound_s(fa.cost(B, S, m["n_heads"], m["n_kv_heads"], m["head_dim"],
                                       m["head_dim"], m["sliding_window"]), p)
                for B, S in ((2, 8), (1, 4)))
    assert read("flash_attention_roofline_pct", dense) == pytest.approx(100 * bound / 200e-9)


def test_quant_matmul_roofline_pct(dense):
    m, p = dense.config["model"], costs.peaks()
    d, H, HK, Dh, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    shapes = [(d, H * Dh), (d, HK * Dh), (d, HK * Dh), (H * Dh, d), (d, f), (f, d)] * m["n_layers"]
    shapes.append((d, m["vocab_size"]))
    bound = sum(qmm.bound_s(qmm.cost(M, k, n), p) for M in (16, 4) for k, n in shapes)
    assert read("quant_matmul_roofline_pct", dense) == pytest.approx(100 * bound / 100e-9)


def test_readers_with_nothing_to_read(dense):
    assert read("mamba_scan_roofline_pct", dense) is None
    bf16 = _rec(dense.config, [{"B": 1, "S": 4, "version": "bf16"}], [(FA, 100, 200)])
    assert read("quant_matmul_roofline_pct", bf16) is None


def test_mamba_scan_roofline_pct_leaves_out_the_backward():
    config = small_config("falcon-mamba-7b")
    m, p = config["model"], costs.peaks()
    rec = _rec(config, [{"B": 1, "S": 16, "version": "bf16"}],
               [(SCAN, 100, 150), (SCAN_BWD, 200, 900), (SCAN, 950, 1000)])
    di = m["ssm_expand"] * m["d_model"]
    bound = m["n_layers"] * ms.bound_s(ms.cost(1, 16, di, m["ssm_state"]), p)
    assert read("mamba_scan_roofline_pct", rec) == pytest.approx(100 * bound / 100e-9)
    assert read("flash_attention_roofline_pct", rec) is None


def test_breakdown(dense):
    out = trace.breakdown(dense)
    assert out["device_ops"][0] == [FA[:160], pytest.approx(200e-9)]
    gaps = dict((k, v) for k, v in out["idle_gaps"])
    # idle [0, 100] at 50 (in aten::mm), [200, 300] at 250, [500, 800] at 650, [900, 1000]
    assert gaps["edgebench.infer.w8: aten::mm"] == pytest.approx(100e-9)
    assert gaps["edgebench.infer.w8: aten::abs"] == pytest.approx(300e-9)
    assert sum(gaps.values()) == pytest.approx(600e-9)
    json.dumps(out)


def test_every_per_layer_metric_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(metrics.reader(m["name"]))


def test_a_cell_named_metric_is_read_by_its_quantity(dense):
    assert metrics.reader("device_idle_pct.some-cell") is metrics.reader("device_idle_pct")
    assert read("device_idle_pct.some-cell", dense) == read("device_idle_pct", dense)


def test_slice_timed_by_the_host_keeps_every_kernel(dense):
    """A slice traced with the device's activity alone has no bounds in the
    trace's clock: its length is the host's, and every kernel counts."""
    rec = trace.Record(dense.config, dense.batches, 2e-6, dense.kernels, costs.peaks())
    # busy 400 ns of 2000
    assert read("device_idle_pct", rec) == pytest.approx(80.0)
    assert trace.busy_s(rec) == pytest.approx(400e-9)


def test_breakdown_names_gaps_from_the_host_traced_slice(dense):
    rec = trace.Record(dense.config, dense.batches, 2e-6, [(QMM, 5000, 5600)], costs.peaks())
    out = trace.breakdown(rec, dense)
    assert out["device_ops"] == [[QMM[:160], pytest.approx(600e-9)]]
    assert sum(v for _, v in out["idle_gaps"]) == pytest.approx(600e-9)


def test_a_trace_without_device_time_fails():
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            with record_function(trace.INFER_SPAN + "w8"):
                x @ x
    with pytest.raises(RuntimeError, match="no device kernel"):
        trace.from_profile(prof, small_config("starcoder2-3b"), [], costs.peaks())
