"""repro_torch's simulate CLI (its ad-hoc half: scenarios assembled from
flags, flag overrides of a preset, the trace overrides and their
refusals), ``render_experiments`` and the two examples, against the
reference's scripts on the CPU. The reference scripts are loaded from
``scripts/`` and ``examples/`` with importlib; their ``main`` reads
``sys.argv``."""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.scenarios import run_scenario as ref_run_scenario  # noqa: E402

from repro_torch.launch import fleet_sim, quickstart, render_experiments  # noqa: E402
from repro_torch.launch import simulate as cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    spec = importlib.util.spec_from_file_location(f"ref_{Path(rel).stem}", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_cli = _load("scripts/simulate.py")
ref_render = _load("scripts/render_experiments.py")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the runs here are small, and one thread does
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def replay_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("replay") / "counts.npy"
    np.save(path, np.random.default_rng(0).poisson(4.0, size=(24, 3)).astype(np.float64))
    return str(path)


def _scenario(mod, argv):
    """The scenario ``mod``'s main builds from ``argv``, by its own
    functions: a preset with the typed overrides, or the ad-hoc one."""
    provided = vars(mod.build_parser().parse_args(argv))
    merged = {**mod.DEFAULTS, **provided}
    if merged["scenario"]:
        return mod.apply_overrides(mod.get_scenario(merged["scenario"]), provided, merged)
    return mod.scenario_from_args(merged)


def _fields(sc):
    out = {}
    for f in dataclasses.fields(sc):
        v = getattr(sc, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        if f.name == "trace_kw":
            v = {k: (x.tolist() if isinstance(x, np.ndarray) else x) for k, x in v.items()}
        out[f.name] = v
    return out


AD_HOC = {
    "no flags": [],
    "poisson rate": ["--trace", "poisson", "--rate", "3.5"],
    "mmpp rates": ["--trace", "mmpp", "--rate-low", "1", "--rate-high", "40", "--devices", "4"],
    "diurnal rates": ["--trace", "diurnal", "--rate-low", "3", "--rate-high", "25",
                      "--slo-ms", "750", "--slot-seconds", "5"],
    "uniform rate": ["--trace", "uniform", "--rate-high", "12", "--models", "vgg",
                     "--peak-rps", "0"],
    "replay": ["--trace", "replay", "--replay-file", "{replay}", "--slot-seconds", "5"],
    "weights and training": ["--w-acc", "0.2", "--w-lat", "0.3", "--w-energy", "0.1",
                             "--w-stab", "0.4", "--episodes", "20", "--train-seed", "3",
                             "--seeds", "0,1", "--engine", "vectorized"],
    "drift and pool": ["--drift-schedule", "link-brownout", "--pool", "uniform-4",
                       "--autoscale", "threshold"],
    "tpu mixtral execute": ["--env", "tpu", "--arch", "mixtral-8x22b", "--execute",
                            "--devices", "2", "--requests", "400", "--sample", "4",
                            "--exec-seq", "16"],
    "preset overridden": ["--scenario", "paper-mmpp-burst", "--devices", "6", "--slo-ms", "1500",
                          "--w-acc", "0.2", "--w-stab", "0.5", "--models", "resnet"],
    "preset rate patched": ["--scenario", "paper-mmpp-burst", "--rate-high", "50"],
    "preset trace kind": ["--scenario", "paper-mmpp-burst", "--trace", "poisson"],
    "preset replay": ["--scenario", "edge-cluster", "--trace", "replay", "--replay-file",
                      "{replay}"],
    "preset tpu arch": ["--scenario", "tpu-submesh", "--env", "tpu", "--arch", "mixtral-8x22b",
                        "--execute", "--peak-rps", "150", "--slot-seconds", "2"],
}


@pytest.mark.parametrize("case", list(AD_HOC))
def test_scenario_from_flags_equals_reference(case, replay_file):
    argv = [a.format(replay=replay_file) for a in AD_HOC[case]]
    want, got = _fields(_scenario(ref_cli, argv)), _fields(_scenario(cli, argv))
    assert got == want
    assert got["name"] == ("custom" if "--scenario" not in argv else argv[1])


# the reference checks rate flags against the trace only where they
# override a preset (an ad-hoc scenario takes its kind's flags and leaves
# the others unread)
REFUSALS = {
    "stray rate flag": ["--scenario", "paper-mmpp-burst", "--rate", "3"],
    "stray rate flag on a new kind": ["--scenario", "paper-mmpp-burst", "--trace", "poisson",
                                      "--rate-low", "3"],
    "replay without a file": ["--trace", "replay"],
    "replay without a file on a preset": ["--scenario", "paper-mmpp-burst", "--trace", "replay"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_trace_refusals_use_the_reference_words(case, monkeypatch):
    argv = REFUSALS[case]
    monkeypatch.setattr(sys, "argv", ["simulate.py", *argv])
    with pytest.raises(SystemExit) as want:
        ref_cli.main()
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    assert isinstance(want.value.code, str) and got.value.code == want.value.code


def test_execute_without_tpu_env_is_refused_in_the_reference_words(monkeypatch, capsys):
    for argv in (["--execute"], ["--scenario", "paper-mmpp-burst", "--execute"]):
        monkeypatch.setattr(sys, "argv", ["simulate.py", *argv])
        with pytest.raises(SystemExit):
            ref_cli.main()
        want = capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1]
        with pytest.raises(SystemExit):
            cli.main(argv + ["--device", "cpu"])
        got = capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1]
        assert got == want and want.startswith("--execute needs --env tpu")


@pytest.fixture(scope="module")
def no_scenario_runs(tmp_path_factory):
    """``--trace mmpp --devices 4 --requests 2000 --compare
    device_only,full_offload --json``, through each CLI."""
    d = tmp_path_factory.mktemp("runs")
    argv = ["--trace", "mmpp", "--devices", "4", "--requests", "2000", "--compare",
            "device_only,full_offload", "--quiet"]
    saved = sys.argv
    sys.argv = ["simulate.py", *argv, "--json", str(d / "ref.json")]
    try:
        ref_cli.main()
    finally:
        sys.argv = saved
    report = cli.main(argv + ["--json", str(d / "port.json"), "--device", "cpu"])
    return (json.loads((d / "ref.json").read_text()), json.loads((d / "port.json").read_text()),
            report, d)


def test_no_scenario_run_writes_the_reference_numbers(no_scenario_runs):
    want, got, report, _ = no_scenario_runs
    assert report.scenario == got["scenario"] == want["scenario"] == "custom"
    assert list(got["policies"]) == ["device_only", "full_offload"]
    assert {k: v for k, v in got.items() if k != "config"} \
        == {k: v for k, v in want.items() if k != "config"}
    assert got["config"] == {**want["config"], "device": "cpu"}


def test_render_from_json_gives_the_reference_markdown(no_scenario_runs, monkeypatch):
    """The no-scenario reports and a drift preset's (per-regime adaptation
    table): every section character for character, under the port's title
    line."""
    _, _, _, d = no_scenario_runs
    drift = ref_run_scenario(ref_get_scenario("link-brownout"), ("device_only",),
                             n_requests=1500, seeds=(0,))
    (d / "drift.json").write_text(json.dumps(drift.to_json(), default=str))
    paths = [str(d / n) for n in ("ref.json", "port.json", "drift.json")]
    monkeypatch.setattr(sys, "argv", ["render_experiments.py", "--from-json", *paths,
                                      "--out", str(d / "ref.md")])
    ref_render.main()
    body = render_experiments.main(["--from-json", *paths, "--out", str(d / "port.md")])
    want = (d / "ref.md").read_text()
    assert (d / "port.md").read_text() == body
    assert body.split("\n", 4)[4] == want.split("\n", 4)[4]
    assert body.splitlines()[2].startswith("Rendered by `python -m repro_torch.launch")
    assert "Per-regime adaptation metrics" in body and body.count("\n## ") == 3
    for path in paths:
        data = json.loads(Path(path).read_text())
        assert render_experiments.render_report(data) == ref_render.render_report(data)
    with pytest.raises(SystemExit):
        render_experiments.main(["--out", str(d / "none.md")])


def test_fleet_sim_gives_the_reference_statics(capsys):
    report = fleet_sim.main(["--devices", "2", "--episodes", "2", "--requests", "2000",
                             "--device", "cpu"])
    assert "best SLO attainment" in capsys.readouterr().out
    ref = ref_run_scenario(ref_get_scenario("paper-mmpp-burst").replace(
        devices=2, episodes=2, n_requests=2000), ("device_only", "full_offload"))
    assert list(report.results) == ["a2c", "device_only", "full_offload"]
    for name, r in ref.results.items():
        assert report.results[name].mean == r.mean, name


def test_quickstart_runs_on_the_cpu(capsys):
    results = quickstart.main(["--episodes", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training A2C for 4 episodes" in out and "device cpu" in out
    assert "a2c" in results and "device_only" in results
    assert all(np.isfinite(m["reward"]) for m in results.values())
    assert results["device_only"]["selection_hist"].sum() > 0
