"""The split path's spans (``repro_torch.obs``) on the CPU: one
``serving.infer`` per ``SplitServingEngine.infer`` with ``split.head``,
``split.link`` and ``split.tail`` inside it, ``quant.act`` at every
activation quantization, ``quant.dequant`` at every weight-only
dequantization, ``serving.build_version`` at a version's first infer only;
results bit-identical with a recorder on and off; the recorder on the
profiler's clock (``time.time_ns``) and the file's header naming it.
Reduced starcoder2-3b and falcon-mamba-7b, one torch thread."""
import json
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import params  # noqa: E402
from repro_torch.obs import Recorder, read_events  # noqa: E402
from repro_torch.serving import SplitServingEngine  # noqa: E402

CUT = ("main", 1)
# w8a8 projections a layer: starcoder2's wq, wk, wv, wo, w_up, w_down;
# falcon-mamba's mixer projections stay f32 in every version
QUANT_A_LAYER = {"starcoder2-3b": 6, "falcon-mamba-7b": 0}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(arch, versions=("bf16", "w8", "w4")):
    cfg = get_config(arch).reduced()
    model = params.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, SplitServingEngine(cfg, model, versions, device="cpu")


def _tokens(cfg, B=2, S=12, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _spans(rec):
    return [e for e in rec.events if e["type"] == "span"]


def _recorded(fn):
    rec = Recorder()
    obs.set_recorder(rec)
    try:
        out = fn()
    finally:
        obs.set_recorder(None)
    return out, _spans(rec)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "falcon-mamba-7b"])
@pytest.mark.parametrize("version", ["bf16", "w8", "w4"])
def test_one_infer_span_with_the_split_inside(arch, version):
    cfg, eng = _engine(arch, (version,))
    tokens = _tokens(cfg)
    _, spans = _recorded(lambda: [eng.infer({"tokens": tokens}, CUT, version) for _ in range(2)])
    infers = [s for s in spans if s["name"] == "serving.infer"]
    assert len(infers) == 2
    assert all(s["depth"] == 0 and s["parent"] is None for s in infers)
    assert infers[0]["attrs"] == {"version": version, "B": 2, "S": 12, "cut": CUT}
    split = [s for s in spans if s["name"].startswith("split.")]
    assert [s["name"] for s in split] == ["split.head", "split.link", "split.tail"] * 2
    assert all(s["depth"] == 1 and s["parent"] == "serving.infer" for s in split)
    # each child lies inside its infer, in order
    for i, inf in enumerate(infers):
        kids = split[3 * i:3 * i + 3]
        assert inf["t"] <= kids[0]["t"]
        for a, b in zip(kids, kids[1:]):
            assert a["t"] + a["dur"] <= b["t"]
        assert kids[-1]["t"] + kids[-1]["dur"] <= inf["t"] + inf["dur"]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "falcon-mamba-7b"])
def test_w8_quantizes_each_projection_and_the_link(arch):
    cfg, eng = _engine(arch, ("w8",))
    eng.infer({"tokens": _tokens(cfg)}, CUT, "w8")          # builds the version
    _, spans = _recorded(lambda: eng.infer({"tokens": _tokens(cfg)}, CUT, "w8"))
    acts = Counter(s["parent"] for s in spans if s["name"] == "quant.act")
    head = 0 if cfg.tie_embeddings else 1
    assert acts["split.link"] == 1
    assert acts["split.head"] == QUANT_A_LAYER[arch] * CUT[1]
    assert acts["split.tail"] == QUANT_A_LAYER[arch] * (cfg.n_layers - CUT[1]) + head
    assert sum(acts.values()) == QUANT_A_LAYER[arch] * cfg.n_layers + head + 1
    assert all("attrs" not in s for s in spans if s["name"].startswith("quant."))
    assert not [s for s in spans if s["name"] == "quant.dequant"]


def test_w4_dequantizes_the_head():
    cfg, eng = _engine("falcon-mamba-7b", ("w4",))
    _, spans = _recorded(lambda: eng.infer({"tokens": _tokens(cfg)}, CUT, "w4"))
    deq = [s for s in spans if s["name"] == "quant.dequant"]
    assert [(s["parent"], s["depth"]) for s in deq] == [("split.tail", 2)]
    assert not [s for s in spans if s["name"] == "quant.act"]


@pytest.mark.parametrize("version", ["bf16", "w4"])
def test_what_each_version_quantizes(version):
    """bf16 quantizes nothing; starcoder2's w4 dequantizes every projection
    and the head (weight-only), and quantizes no activation."""
    cfg, eng = _engine("starcoder2-3b", (version,))
    _, spans = _recorded(lambda: eng.infer({"tokens": _tokens(cfg)}, CUT, version))
    names = Counter(s["name"] for s in spans)
    dequant = QUANT_A_LAYER["starcoder2-3b"] * cfg.n_layers + 1 if version == "w4" else 0
    assert (names["quant.act"], names["quant.dequant"]) == (0, dequant)


def test_a_version_is_built_on_its_first_infer_only():
    cfg, eng = _engine("starcoder2-3b", ("bf16", "w8"))
    tokens = _tokens(cfg)
    _, spans = _recorded(lambda: [eng.infer({"tokens": tokens}, CUT, v)
                                  for v in ("w8", "w8", "bf16", "w8", "bf16")])
    infers = [s for s in spans if s["name"] == "serving.infer"]
    builds = [s for s in spans if s["name"] == "serving.build_version"]
    assert [b["attrs"]["version"] for b in builds] == ["w8", "bf16"]
    assert all(b["parent"] == "serving.infer" and b["depth"] == 1 for b in builds)
    # inside the first w8 infer and the first bf16 infer
    for b, inf in zip(builds, (infers[0], infers[2])):
        assert inf["t"] <= b["t"] and b["t"] + b["dur"] <= inf["t"] + inf["dur"]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "falcon-mamba-7b"])
def test_results_bit_identical_with_the_recorder_on_and_off(arch):
    cfg, eng = _engine(arch)
    tokens = _tokens(cfg, 3, 10, 5)
    for version in ("bf16", "w8", "w4"):
        off = eng.infer({"tokens": tokens}, CUT, version)
        on, spans = _recorded(lambda: eng.infer({"tokens": tokens}, CUT, version))
        assert spans
        assert torch.equal(off[0], on[0]) and off[1] == on[1]
    assert isinstance(obs.get_recorder(), obs.NullRecorder)


def test_spans_on_the_profilers_clock(tmp_path):
    """A recorder on ``time.time_ns`` places each span in Unix ns
    (``t0 + t``), between readings of that clock taken around the infer, and
    its file's header names the clock."""
    cfg, eng = _engine("starcoder2-3b", ("w8",))
    path = str(tmp_path / "spans.jsonl")
    rec = Recorder(path, clock=time.time_ns)
    obs.set_recorder(rec)
    try:
        before = time.time_ns()
        eng.infer({"tokens": _tokens(cfg)}, CUT, "w8")
        after = time.time_ns()
    finally:
        obs.set_recorder(None)
    rec.close()
    spans = _spans(rec)
    assert spans and all(isinstance(s["t"], int) and isinstance(s["dur"], int) for s in spans)
    assert all(before <= rec.t0 + s["t"] <= rec.t0 + s["t"] + s["dur"] <= after for s in spans)
    meta, events = read_events(path)
    assert meta["clock"] == "time_ns"
    assert [e for e in events if e["type"] == "span"] == json.loads(json.dumps(spans))


def test_the_default_header_stays_perf_counter(tmp_path):
    path = str(tmp_path / "e.jsonl")
    with obs.recording(path):
        with obs.span("x"):
            pass
    assert read_events(path)[0]["clock"] == "perf_counter"
