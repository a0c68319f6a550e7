"""The fleet loop's acceptance run in the port, on the CPU: an A2C
controller trained in torch beats the static baselines on SLO attainment
under bursty traffic, at the reference's settings
(``tests/test_sim.py::test_a2c_beats_static_baselines_on_mmpp``). In a
file of its own, so that a distributed run gives it a worker."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core.latency import LatencyParams  # noqa: E402
from repro_torch.policies import build_policy  # noqa: E402
from repro_torch.sim import FleetConfig, MMPPTrace, simulate  # noqa: E402
from repro_torch.sim.traces import RandomRateTrace  # noqa: E402


@pytest.fixture
def one_thread():
    """Train on one intra-op thread: the update's ops are small, so one
    thread is as fast alone, and it does not spin against the other test
    workers' threads when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a2c_beats_static_baselines_on_mmpp(one_thread):
    """The stability-aware, domain-randomized A2C controller (500 updates,
    entropy 0.03, trained on ``RandomRateTrace(max_rps=30)``) must beat
    all-local and always-max-offload on mean SLO attainment under the
    bursty MMPP trace (2 -> 30 rps a device), over the paired request
    streams of seeds 0, 2 and 4 at 20,000 requests each."""
    n, burst = 4, 30.0
    lat = LatencyParams(server_flops=0.55e12 * n, bw_max_bps=1e9)
    w = T.RewardWeights(w_acc=0.05, w_lat=0.1, w_energy=0.15, w_stab=0.7)
    cfg, tables = T.make_paper_env(n_uavs=n, latency=lat, weights=w,
                                   peak_rps=burst, slot_seconds=10.0,
                                   frames_per_slot=10.0 * burst, device="cpu")
    mids = np.zeros(n, np.int32)   # homogeneous vgg fleet
    a2c = build_policy("a2c", cfg, tables, episodes=500, entropy_coef=0.03)
    hist = a2c.train(seed=0, trace=RandomRateTrace(max_rps=burst))
    assert np.isfinite([h["loss"] for h in hist]).all()
    trace = MMPPTrace(rate_low_rps=2.0, rate_high_rps=burst)

    def mean_slo(policy):
        vals = []
        for seed in (0, 2, 4):
            res = simulate(cfg, tables, policy, trace, n_requests=20_000,
                           seed=seed, fleet=FleetConfig(slo_s=2.0),
                           model_ids=mids)
            vals.append(res.summary["slo_attainment"])
        return float(np.mean(vals))

    a2c_slo = mean_slo(a2c)
    local = mean_slo(build_policy("device_only", cfg, tables))
    offload = mean_slo(build_policy("full_offload", cfg, tables))
    assert a2c_slo > local, (a2c_slo, local)
    assert a2c_slo > offload, (a2c_slo, offload)
