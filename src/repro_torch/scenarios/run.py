"""``run_scenario``: the single experiment entry point (port of
``repro.scenarios.run``).

Builds the scenario's world once, on one device, resolves every
requested policy through the canonical registry (training, or loading a
saved artifact, where the spec is trainable), and simulates each policy
over the *same* seeds, so comparisons are paired by construction: two
policies under one seed face the identical request stream.

The reference's ``"<name>+online"`` roster entries (closed-loop online
adaptation) and its flight-recorder timeline raise until
``repro.online`` and ``repro.obs`` are ported (ROADMAP section 1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.policies import get_policy_spec
from repro_torch.scenarios.base import Scenario
from repro_torch.sim import FleetConfig, simulate

_TABLE_HEADER = (f"{'policy':14s} {'requests':>9s} {'p50_s':>8s} "
                 f"{'p95_s':>8s} {'p99_s':>8s} {'slo_att':>8s} "
                 f"{'goodput':>8s} {'E/req_J':>8s} {'drop':>6s}")


def split_policy_name(name: str) -> Tuple[str, bool]:
    """``"a2c+online" -> ("a2c", True)``; any other ``+suffix`` is an
    error (fail before building an env for a typo'd roster)."""
    base, sep, suffix = name.partition("+")
    if not sep:
        return name, False
    if suffix != "online":
        raise KeyError(f"unknown policy modifier {'+' + suffix!r} in "
                       f"{name!r}; the only modifier is '+online'")
    return base, True


@dataclasses.dataclass
class PolicyResult:
    """One policy's paired-seed outcome inside a ComparisonReport."""
    name: str
    mean: Dict[str, float]
    per_seed: List[Dict]
    trained: bool = False
    loaded_from: Optional[str] = None
    saved_to: Optional[str] = None
    cross_check: Optional[Dict] = None

    def row(self) -> str:
        m = self.mean
        return (f"{self.name:14s} {m['count']:9.0f} {m['p50']:8.3f} "
                f"{m['p95']:8.2f} {m['p99']:8.2f} "
                f"{m['slo_attainment']:8.3f} {m['goodput']:8.1f} "
                f"{m['energy_per_request_j']:8.3f} {m['dropped']:6.0f}")


@dataclasses.dataclass
class ComparisonReport:
    """Paired-seed comparison of N policies under one scenario."""
    scenario: str
    seeds: Tuple[int, ...]
    n_requests: int
    trace: str
    results: Dict[str, PolicyResult]     # insertion-ordered

    def table(self) -> str:
        return "\n".join([_TABLE_HEADER]
                         + [r.row() for r in self.results.values()])

    def to_json(self) -> Dict:
        out = {"scenario": self.scenario, "seeds": list(self.seeds),
               "n_requests": self.n_requests, "trace": self.trace,
               "policies": {}}
        for name, r in self.results.items():
            entry = {"mean": r.mean, "per_seed": r.per_seed,
                     "trained": r.trained}
            if r.loaded_from:
                entry["loaded_from"] = r.loaded_from
            if r.saved_to:
                entry["saved_to"] = r.saved_to
            if r.cross_check:
                entry["cross_check"] = {k: v for k, v in
                                        r.cross_check.items()
                                        if k != "records"}
            out["policies"][name] = entry
        return out


def run_scenario(scenario: Scenario,
                 policies: Optional[Sequence[str]] = None, *,
                 device: DeviceLike = None,
                 n_requests: Optional[int] = None,
                 seeds: Optional[Sequence[int]] = None,
                 episodes: Optional[int] = None,
                 load_policies: Optional[Mapping[str, str]] = None,
                 save_policies: Optional[Mapping[str, str]] = None,
                 verbose: bool = False,
                 timeline: bool = False) -> ComparisonReport:
    """Run ``policies`` (default: the scenario's own roster) through the
    scenario on ``device`` (the CUDA card unless another is named);
    returns a paired-seed ComparisonReport.

    ``load_policies``/``save_policies`` map policy name -> artifact path:
    a mapped trainable policy loads instead of training (identical
    paired-seed metrics to the run that saved it, no retraining), and
    saves right after training. ``n_requests``/``seeds``/``episodes``
    override the scenario without mutating it. ``verbose`` prints the
    narration and the table.
    """
    names = tuple(policies) if policies else scenario.policies
    parsed = [split_policy_name(n) for n in names]
    specs = [get_policy_spec(b) for b, _ in parsed]   # fail fast on typos
    online = [n for n, (_, is_online) in zip(names, parsed) if is_online]
    if online:
        raise NotImplementedError(
            f"{', '.join(online)}: online adaptation (repro.online) is not "
            "ported yet (ROADMAP section 1, item 3)")
    if timeline:
        raise NotImplementedError("the flight-recorder timeline (repro.obs.timeline) "
                                  "is not ported yet (ROADMAP section 1, item 3)")
    seeds = tuple(seeds) if seeds is not None else scenario.seeds
    n_req = int(n_requests) if n_requests is not None \
        else scenario.n_requests
    eps = int(episodes) if episodes is not None else scenario.episodes

    env_cfg, tables, model_ids, backend_factory = scenario.build_env(device)
    trace = scenario.build_trace()
    schedule = scenario.build_schedule()
    autoscaler = scenario.build_autoscaler()
    fleet = FleetConfig(slo_s=scenario.slo_s, engine=scenario.engine)

    say = print if verbose else (lambda *a, **k: None)
    say(f"scenario {scenario.name}: {scenario.devices} devices "
        f"({scenario.env} env, on {tables.device}), trace={trace.name} "
        f"(mean {trace.mean_rps:.1f} rps/device), "
        f"slo={scenario.slo_s}s, requests={n_req} x seeds {list(seeds)}")

    results: Dict[str, PolicyResult] = {}
    header_printed = False
    for name, spec in zip(names, specs):
        kw = {}
        if spec.trainable:
            kw = dict(episodes=eps, entropy_coef=scenario.entropy_coef,
                      batch_envs=scenario.batch_envs)
        policy = spec.build(env_cfg, tables, **kw)
        trained, loaded_from, saved_to = False, None, None
        if spec.trainable:
            loaded_from = (load_policies or {}).get(name)
            if loaded_from:
                policy.load(loaded_from)
                say(f"{name}: loaded artifact {loaded_from}")
            else:
                say(f"{name}: training ({eps} episodes) ...")
                hist = policy.train(seed=scenario.train_seed,
                                    trace=scenario.build_train_trace())
                trained = True
                last = np.mean([h["mean_reward"] for h in hist[-15:]])
                say(f"  trained: mean reward (last 15 episodes) = "
                    f"{last:+.3f}")
            saved_to = (save_policies or {}).get(name)
            if saved_to:
                policy.save(saved_to)
                say(f"{name}: saved artifact {saved_to}")

        per_seed, cross = [], None
        for seed in seeds:
            res = simulate(env_cfg, tables, policy, trace,
                           n_requests=n_req, seed=seed, fleet=fleet,
                           backend=backend_factory(), model_ids=model_ids,
                           schedule=schedule, autoscaler=autoscaler)
            per_seed.append(res.summary)
            cross = res.cross_check or cross
        mean = {k: float(np.mean([s[k] for s in per_seed]))
                for k in per_seed[0] if k != "unit"}
        results[name] = PolicyResult(
            name=name, mean=mean, per_seed=per_seed, trained=trained,
            loaded_from=loaded_from, saved_to=saved_to, cross_check=cross)
        if not header_printed:
            say("\n" + _TABLE_HEADER)
            header_printed = True
        say(results[name].row())

    return ComparisonReport(scenario=scenario.name, seeds=seeds,
                            n_requests=n_req, trace=trace.name,
                            results=results)
