"""Sharded steps and the dry run of repro_torch on the CPU.

The sharded steps run in a subprocess (``tests/torch_sharded_worker.py``)
that starts one group of 4 gloo processes, so no test process keeps a
process group: on meshes (1, 4), (2, 2) and (4, 1), reduced qwen2 (H 4 and
HK 2, whose kv heads are sharded over the model axis of 2 on the (2, 2)
mesh) trains one step and serves one step, and reduced falcon-mamba (its
``inner`` channels sharded over the model axis) trains one step, each held
against the same step on an unsharded copy of the same weights; so do
reduced mixtral and deepseek (the MoE layer on shards) on one mesh each.
The dry run
runs in a subprocess of its own as ``tests/test_dryrun_integration.py``
runs the reference's, and must fail in a directory without the package."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
MESHES = ([1, 4], [2, 2], [4, 1])
CASES = [(mesh, kind, arch) for mesh in MESHES
         for kind, arch in (("train", "qwen2-0.5b"), ("serve", "qwen2-0.5b"),
                            ("train", "falcon-mamba-7b"))]
# the MoE layer on shards: reduced mixtral's 4 experts split over the model
# axis, with 3 experts their hidden width split instead; reduced deepseek
CASES += [([2, 2], "train", "mixtral-8x22b"), ([1, 4], "train", "mixtral-8x22b/E3"),
          ([2, 2], "train", "deepseek-v2-lite-16b")]


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def sharded_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded") / "results.json"
    r = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_sharded_worker.py"),
                        str(out), "4"], env=_env(), capture_output=True, text=True,
                       timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return {(tuple(c["mesh"]), c["kind"], c["arch"]): c for c in json.loads(out.read_text())}


@pytest.mark.parametrize("mesh,kind,arch", CASES)
def test_sharded_step_equals_the_unsharded_one(sharded_results, mesh, kind, arch):
    case = sharded_results[(tuple(mesh), kind, arch)]
    if kind == "train":
        ref, got = case["loss"]
        assert abs(got - ref) <= TOL * abs(ref)
        for what in ("grads", "params"):
            assert len(case[what]) > 10
            worst = max(case[what], key=case[what].get)
            assert case[what][worst] <= TOL, (what, worst)
    else:
        assert case["logits"] <= TOL


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen2-0.5b", "decode_32k", "single"),
])
def test_dryrun_combo(tmp_path, arch, shape, mesh):
    out = tmp_path / "dryrun.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(out.read_text().strip().splitlines()[-1])
    assert rec["status"] == "ok"
    assert rec["devices"] == (512 if mesh == "multi" else 256)
    assert rec["jaxpr_flops"] > 0
    assert "collectives" in rec
    assert rec["argument_size_in_bytes"] > 0
    for key in ("hlo_flops", "compile_s", "generated_code_size_in_bytes"):
        assert key not in rec


def test_dryrun_records_a_failure_and_exits_nonzero(tmp_path, monkeypatch):
    """An op without a sharding strategy or one that needs data is a fail
    record with its error, not a skipped combo (in process: the step is
    made to raise before any group starts)."""
    from repro_torch.launch import dryrun

    def boom(*a, **k):
        raise RuntimeError("no sharding strategy for this op")

    monkeypatch.setattr(dryrun, "fake_group", lambda world: None)
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda **k: _OneMesh())
    monkeypatch.setattr(dryrun, "step_inputs", boom)
    out = tmp_path / "d.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh", "single",
                     "--out", str(out)])
    assert e.value.code == 1
    rec = json.loads(out.read_text())
    assert rec["status"] == "fail" and "no sharding strategy" in rec["error"]
    assert dryrun.load_done(str(out))[("qwen2-0.5b", "train_4k", "single", "baseline")] == rec


class _OneMesh:
    def size(self):
        return 256
