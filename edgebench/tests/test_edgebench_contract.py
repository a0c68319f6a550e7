"""BENCHMARK.json holds to the benchmark's contract, and everything a cell
names is a file the harness finds by name."""
import re
from pathlib import Path

import pytest

from edgebench import check, harness, workload

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["edgebench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            assert NAME.match(e["name"]), e["name"]
            names.add((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert len(e.get("why", "x")) <= 200 and "\n" not in e.get("why", "")
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])
    moves = {e["name"] for e in BENCH["end_to_end"]}
    for e in BENCH["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["moves"] in moves and 1 <= len(e["layer"]) <= 200


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        config = harness.load_config(w["config"])
        assert config["name"] == w["config"] and config["source"] == configs[w["config"]]["source"]
        assert config["reduced"] == configs[w["config"]]["reduced"] == []
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        workload.load_mix(w["traffic"])
        assert check.load_limits(w["name"]), w["name"]
        for m in BENCH["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                quantity = m["name"].split(".")[0]
                assert (ROOT / "edgebench" / "metrics" / f"{quantity}.py").is_file()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_is_the_ports(name):
    harness.port_config(harness.load_config(name))
