"""repro_torch's scan engine sharded over a torch.distributed group, on the
CPU, and the static policies on a device shard.

``tests/torch_scan_shard_worker.py`` runs in a subprocess and starts gloo
groups of 1, 2, 3 and 4 processes, so no test process keeps a group; each
runs ``FleetConfig(engine="scan", shard=True)`` twice on diurnal-fleet (8
devices; at its load, and under a load whose tail work outgrows the slot,
so the server backlog builds), and on megafleet cut to 30,001 devices
(which no world size divides, so the fleet axis is padded with dead
devices), and the group of one runs ``shard=False`` beside it. While it runs, this process runs the
reference's unsharded scan on the same worlds. Held:

- world size 1 equals shard=False bit for bit: summary, selection
  histogram, epoch log, timeline, served and epochs;
- at world sizes 2, 3 and 4: served, epochs, requests, per-epoch arrivals,
  drops and live devices (the padding is dead) equal shard=False and the
  reference's unsharded scan exactly;
  device_only's and full_offload's selection histograms too (no battery
  runs out: asserted first); the summary within the scan contract
  (``assert_statistically_close``) of both, where the contract holds it
  (device_only; full_offload on the 30,001-device world: in the 8-device
  world one noise path decides it, as tests/test_torch_megafleet_scan.py
  says); greedy_oracle, which reads the server's one queue (a single noise
  path each run draws for itself), epoch by epoch where the queues agree;
  the server backlog, which only the fleet's summed tail work feeds, within
  f32 rounding of both;
- two runs are bit-identical, every rank returns the same results, and a
  sharded run makes one all-reduce an epoch and three after the loop.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.policies import build_policy as ref_build_policy  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.sim import FleetConfig as RefFleetConfig  # noqa: E402
from repro.sim import simulate as ref_simulate  # noqa: E402

import torch_scan_shard_worker as worker  # noqa: E402
from test_torch_megafleet_scan import (ENERGY_REL, MEAN_REL, SLO_ABS,  # noqa: E402
                                       assert_statistically_close)

from repro_torch.core.controller import measured_state  # noqa: E402
from repro_torch.policies import build_policy  # noqa: E402
from repro_torch.scenarios import get_scenario  # noqa: E402
from repro_torch.sim.megafleet import shard_seed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 3, 4)
SHARDED = (2, 3, 4)
CASES = [(label, policy) for label, _, _, _, policies in worker.CASES for policy in policies]
STATIC = [c for c in CASES if c[1] in ("device_only", "full_offload")]
# the cases the scan contract holds at the summary (see the module docstring)
CLOSE = [("diurnal-fleet", "device_only"), ("megafleet", "device_only"),
         ("megafleet", "full_offload")]
# after the loop: the integer sums, the f32 sums, the largest latency
AFTER_LOOP = 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _ref_runs():
    """The reference's unsharded scan on each case, as the worker records
    its runs."""
    out = {}
    for label, name, overrides, n_requests, policies in worker.CASES:
        sc = ref_get_scenario(name).replace(**overrides)
        env_cfg, tables, mids, _ = sc.build_env()
        for policy in policies:
            res = ref_simulate(env_cfg, tables, ref_build_policy(policy, env_cfg, tables),
                               sc.build_trace(), n_requests=n_requests, seed=sc.seeds[0],
                               model_ids=mids, fleet=RefFleetConfig(
                                   slo_s=sc.slo_s, engine="scan", timeline=True))
            out[label, policy] = json.loads(json.dumps(worker._record(res)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({(world, rank): {(scenario, policy): case}}, {(scenario, policy):
    the reference's record})."""
    out = tmp_path_factory.mktemp("scan_shard")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_scan_shard_worker.py"), str(out),
         *map(str, WORLDS)], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ref = _ref_runs()
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    got = {}
    for w in WORLDS:
        for r in range(w):
            with open(out / f"w{w}_r{r}.json") as f:
                got[w, r] = {(c["case"], c["policy"]): c for c in json.load(f)}
    return got, ref


def _same(a, b) -> bool:
    """Bit for bit (floats round-trip through JSON exactly)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _result(rec):
    return types.SimpleNamespace(summary=rec["summary"],
                                 selection_hist=np.asarray(rec["selection_hist"]))


def _column(rec, key):
    return np.asarray(rec["timeline"]["columns"][key], dtype=np.float64)


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_world_size_one_equals_unsharded_bit_for_bit(runs, case):
    c = runs[0][1, 0][case]
    assert _same(c["runs"][0], c["unsharded"]) and _same(c["runs"][1], c["unsharded"])
    assert c["unsharded_all_reduce"] == 0
    assert c["all_reduce"] == [c["unsharded"]["epochs"] + AFTER_LOOP] * 2


@pytest.mark.parametrize("case", CASES, ids="-".join)
@pytest.mark.parametrize("world", SHARDED)
def test_sharded_workload_equals_unsharded_and_the_reference(runs, world, case):
    got, ref = runs
    a, u, r = got[world, 0][case]["runs"][0], got[1, 0][case]["unsharded"], ref[case]
    for b in (u, r):
        assert (a["epochs"], a["served"], a["duration_s"]) == \
            (b["epochs"], b["served"], b["duration_s"])
        assert a["summary"]["requests"] == b["summary"]["requests"]
        assert a["summary"]["count"] == b["summary"]["count"]
        for key in ("arrivals", "dropped", "alive"):
            assert a["epoch_log"][key] == b["epoch_log"][key], key
        assert np.sum(a["selection_hist"]) == np.sum(b["selection_hist"])
    assert a["timeline"]["columns"]["arrivals"] == u["timeline"]["columns"]["arrivals"]


@pytest.mark.parametrize("case", STATIC, ids="-".join)
@pytest.mark.parametrize("world", SHARDED)
def test_static_selection_hist_exact(runs, world, case):
    got, ref = runs
    a = got[world, 0][case]["runs"][0]
    assert a["dropped"] == 0 and a["summary"]["dropped"] == 0
    assert a["selection_hist"] == got[1, 0][case]["unsharded"]["selection_hist"]
    assert a["selection_hist"] == ref[case]["selection_hist"]


@pytest.mark.parametrize("case", CLOSE, ids="-".join)
@pytest.mark.parametrize("world", SHARDED)
def test_summary_statistically_close(runs, world, case):
    got, ref = runs
    a = _result(got[world, 0][case]["runs"][0])
    for b in (got[1, 0][case]["unsharded"], ref[case]):
        assert_statistically_close(a, _result(b), shares=False)


@pytest.mark.parametrize("world", SHARDED)
def test_server_backlog_follows_the_fleets_tail_work(runs, world):
    """full_offload's tail work depends on the counts and the models only,
    so the backlog it builds is the same path in every run, up to the order
    of the f32 sums: the epoch's all-reduce gives every rank the whole
    fleet's tail work."""
    got, ref = runs
    case = ("diurnal-fleet-busy", "full_offload")
    a = got[world, 0][case]["runs"][0]
    backlog = np.asarray(a["epoch_log"]["backlog_s"])
    assert a["dropped"] == 0 and np.all(np.diff(backlog) > 0) and backlog[0] > 0
    for b in (got[1, 0][case]["unsharded"], ref[case]):
        np.testing.assert_allclose(backlog, b["epoch_log"]["backlog_s"], rtol=1e-5)


@pytest.mark.parametrize("world", SHARDED)
def test_greedy_oracle_epoch_by_epoch_at_an_equal_queue(runs, world):
    """greedy_oracle reads the server's queue, one noise path a run draws
    for itself: where two runs' decision-time queues agree, that epoch's
    energy, SLO attainment and mean latency are within the contract; the
    selection shares too when the whole paths agree."""
    got, ref = runs
    case = ("megafleet", "greedy_oracle")
    a = got[world, 0][case]["runs"][0]
    for b in (got[1, 0][case]["unsharded"], ref[case]):
        qa, qb = _column(a, "queue_jobs"), _column(b, "queue_jobs")
        same = np.isclose(qa, qb, rtol=1e-6, atol=1e-6)
        assert same.any() and same[0]
        ea, eb = _column(a, "energy_wh")[same], _column(b, "energy_wh")[same]
        np.testing.assert_allclose(ea, eb, rtol=ENERGY_REL)
        sa, sb = (_column(x, "slo_hits")[same] / np.maximum(_column(x, "arrivals")[same], 1)
                  for x in (a, b))
        assert np.all(np.abs(sa - sb) < SLO_ABS)
        np.testing.assert_allclose(_column(a, "lat_mean")[same], _column(b, "lat_mean")[same],
                                   rtol=MEAN_REL)
        if same.all():
            assert_statistically_close(_result(a), _result(b), shares=True)


@pytest.mark.parametrize("world", SHARDED)
def test_two_runs_identical_every_rank_agrees_one_collective_an_epoch(runs, world):
    got, _ = runs
    for case in CASES:
        c = got[world, 0][case]
        assert _same(c["runs"][0], c["runs"][1]), case
        for rank in range(1, world):
            assert _same(got[world, rank][case]["runs"], c["runs"]), (case, rank)
        for rank in range(world):
            assert got[world, rank][case]["all_reduce"] == \
                [c["runs"][0]["epochs"] + AFTER_LOOP] * 2, (case, rank)


# --------------------------------------------------------------------------
# the static policies on a shard, the shard seeds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["device_only", "full_offload", "random", "greedy_oracle"])
def test_static_policy_on_a_sub_fleet_gets_the_whole_fleets_rows(policy):
    """A state sliced to devices 3..8 of a 12-device fleet: the rows the
    whole fleet's call gives those devices (random: the shape, valid
    versions and cuts, from the shard's own draws)."""
    sc = get_scenario("megafleet").replace(devices=12)
    env_cfg, tables, mids, _ = sc.build_env(device="cpu")
    lp, pw = env_cfg.latency, env_cfg.power
    r = np.random.default_rng(3)
    n = env_cfg.n_uavs
    state = measured_state(
        env_cfg, tables, battery_j=r.uniform(0.1, 1.0, n) * pw.battery_j,
        bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, n),
        p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, n), queue_jobs=2.0,
        load=r.uniform(0.0, 1.0, n), model_id=mids,
        activity=r.dirichlet(np.ones(3), n), t=4)
    blk = slice(3, 9)
    sub = {k: (v[blk] if v.dim() and v.shape[0] == n else v) for k, v in state.items()}
    pol = build_policy(policy, env_cfg, tables)
    whole = pol.act(state, torch.Generator().manual_seed(0))
    part = pol.act(sub, torch.Generator().manual_seed(0))
    assert part.shape == (6, whole.shape[1]) and part.dtype == whole.dtype
    if policy == "random":
        nv = tables.version_valid[sub["model_id"]].sum(-1)
        assert torch.all((part[:, 0] >= 0) & (part[:, 0] < nv))
        assert torch.all((part[:, 1] >= 0) & (part[:, 1] < tables.n_cuts))
    else:
        assert torch.equal(part, whole[blk])


def test_shard_seed():
    assert shard_seed(7, 0) == 7
    seeds = [shard_seed(7, r) for r in range(1, 5)]
    assert len(set(seeds + [7])) == 5 and seeds == [shard_seed(7, r) for r in range(1, 5)]
    assert seeds[0] == int(np.random.SeedSequence((7, 1)).generate_state(1, np.uint64)[0])
    torch.Generator().manual_seed(max(seeds))
