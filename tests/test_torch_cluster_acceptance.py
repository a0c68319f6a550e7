"""The routing acceptance on the CPU: an A2C trained in torch at the
cluster-brownout preset's settings (400 updates of 4 envs, entropy 0.03,
training seed 0) against the round_robin and join_shortest_queue routers
on seeds 0 and 1 at 60,000 requests, as the reference's acceptance runs.

The reference's relation measured on the same host (its A2C trained at
training seeds 0-5 with the same settings): mean SLO attainment 0.710 to
0.801 against round_robin 0.839 and join_shortest_queue 0.878, so the
trained router sits below both routers at every training seed, and the
routers keep their order. The port is held to that relation, and to
having learned: its trained agent above its own initial one on the same
requests. A file of its own, so that it gets a test worker to itself."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import init_agent  # noqa: E402
from repro_torch.policies import A2CPolicy  # noqa: E402
from repro_torch.scenarios import get_scenario, run_scenario  # noqa: E402
from repro_torch.sim import FleetConfig, simulate  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: A2C's ops are small here, and one thread does
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_routing_a2c_holds_the_reference_relation_under_cluster_brownout():
    sc = get_scenario("cluster-brownout")
    assert (sc.episodes, sc.entropy_coef, sc.batch_envs, sc.n_requests, sc.seeds) \
        == (400, 0.03, 4, 60_000, (0, 1))
    report = run_scenario(sc, ("a2c", "round_robin", "join_shortest_queue"), device="cpu")
    slo = {name: r.mean["slo_attainment"] for name, r in report.results.items()}
    assert report.results["a2c"].trained
    # the initial agent the training starts from (drawn first from the
    # training seed's generator), on the same requests
    env_cfg, tables, model_ids, _ = sc.build_env(device="cpu")
    init = A2CPolicy(env_cfg, tables)
    init.set_params(init_agent(env_cfg, tables, init.config,
                               torch.Generator().manual_seed(sc.train_seed)))
    slo["a2c@init"] = float(np.mean([simulate(
        env_cfg, tables, init, sc.build_trace(), n_requests=sc.n_requests, seed=seed,
        model_ids=model_ids, fleet=FleetConfig(slo_s=sc.slo_s), schedule=sc.build_schedule(),
        autoscaler=sc.build_autoscaler()).summary["slo_attainment"] for seed in sc.seeds]))
    print(slo)
    assert slo["a2c"] < slo["round_robin"] < slo["join_shortest_queue"]
    assert slo["a2c"] > slo["a2c@init"]
    assert all(np.isfinite(s["p95"]) for s in report.results["a2c"].per_seed)
