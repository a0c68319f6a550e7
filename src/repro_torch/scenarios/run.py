"""``run_scenario``: the single experiment entry point (port of
``repro.scenarios.run``).

Builds the scenario's world once, on one device, resolves every
requested policy through the canonical registry (training, or loading a
saved artifact, where the spec is trainable), and simulates each policy
over the *same* seeds, so comparisons are paired by construction: two
policies under one seed face the identical request stream.

Nonstationary scenarios (``scenario.drift``) run every policy under the
same ``WorldSchedule``. A roster entry ``"<name>+online"`` (e.g.
``"a2c+online"``) runs the trainable policy with closed-loop online
adaptation (``repro_torch.online``): it shares the pre-drift trained
agent with its frozen sibling (train once; the learner adapts a copy),
restarts from it for every seed, and reports per-regime adaptation
metrics (regret vs the per-regime greedy oracle and recovery time) in
its ``PolicyResult.adaptation``.

Cluster scenarios (``scenario.pool``) widen the actions to (version,
cut, server) over the scenario's server pool and topology, and every
simulation runs the scenario's autoscaler on its own ``ServerPool``.
``timeline=True`` turns on the flight recorder for every simulation
(``FleetConfig.timeline``), and ``Scenario.engine`` picks the epoch-flow
engine (``"scan"`` runs the epoch loop on the scenario's device).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
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
    # seed-averaged drift/adaptation metrics (nonstationary scenarios):
    # per-regime mean reward / oracle / regret / recovery_epochs, plus
    # online-learner counters for "+online" entries
    adaptation: Optional[Dict] = None
    # SLO error budgets (timeline runs): seed-mean + per-seed summaries
    # from repro_torch.obs.slo (target, attainment, budget_remaining, alerts)
    slo: Optional[Dict] = None
    # timeline runs: one repro_torch.obs.timeline.Timeline per seed (kept
    # as live objects; launch.simulate --timeline-out serializes them)
    timelines: List = dataclasses.field(default_factory=list)

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
    schedule: Optional[str] = None       # drift schedule name, if any

    def table(self) -> str:
        return "\n".join([_TABLE_HEADER]
                         + [r.row() for r in self.results.values()])
    def adaptation_table(self) -> str:
        """Per-regime adaptation metrics for every policy that has them
        (empty string for stationary scenarios)."""
        lines = []
        for r in self.results.values():
            if not r.adaptation:
                continue
            lines.append(f"{r.name}: mean_reward="
                         f"{r.adaptation['mean_reward']:+.3f} "
                         f"regret={r.adaptation['regret']:.3f}"
                         + (f" updates={r.adaptation['online']['updates']}"
                            f" bursts={r.adaptation['online']['bursts']}"
                            if r.adaptation.get("online") else ""))
            for reg in r.adaptation["regimes"]:
                rec = reg["recovery_epochs"]
                lines.append(
                    f"  regime {reg['regime']} ({reg['name']}): "
                    f"reward={reg['mean_reward']:+.3f} "
                    f"oracle={reg['oracle_reward']:+.3f} "
                    f"regret={reg['regret']:.3f} recovery="
                    + ("never" if rec is None else f"{rec:.0f} epochs"))
        return "\n".join(lines)


    def to_json(self) -> Dict:
        out = {"scenario": self.scenario, "seeds": list(self.seeds),
               "n_requests": self.n_requests, "trace": self.trace,
               "policies": {}}
        if self.schedule:
            out["schedule"] = self.schedule
        for name, r in self.results.items():
            entry = {"mean": r.mean, "per_seed": r.per_seed,
                     "trained": r.trained}
            if r.loaded_from:
                entry["loaded_from"] = r.loaded_from
            if r.saved_to:
                entry["saved_to"] = r.saved_to
            if r.adaptation:
                entry["adaptation"] = r.adaptation
            if r.slo:
                entry["slo"] = r.slo
            if r.cross_check:
                entry["cross_check"] = {k: v for k, v in
                                        r.cross_check.items()
                                        if k != "records"}
            out["policies"][name] = entry
        return out


def _strip_series(adapt: Dict) -> Dict:
    """Per-seed adaptation dict without the per-epoch reward series
    (SimResult keeps them; the report stores summaries)."""
    out = dict(adapt)
    out["regimes"] = [{k: v for k, v in reg.items()
                       if k not in ("rewards", "oracle")}
                      for reg in adapt["regimes"]]
    return out


def _mean_adaptation(per_seed: List[Dict]) -> Dict:
    """Seed-average the adaptation summaries: scalar fields averaged,
    per-regime entries averaged by regime index, recovery averaged over
    the seeds that recovered (None if none did)."""
    out = {k: float(np.mean([a[k] for a in per_seed]))
           for k in ("mean_reward", "oracle_reward", "regret")}
    out["schedule"] = per_seed[0].get("schedule")
    regimes = []
    # regimes reached differ per seed (epoch count to serve n_requests
    # is seed-dependent): aggregate over the union, averaging each
    # regime over the seeds that reached it
    n_regimes = max(len(a["regimes"]) for a in per_seed)
    for i in range(n_regimes):
        regs = [a["regimes"][i] for a in per_seed
                if i < len(a["regimes"])]
        entry = {"regime": regs[0]["regime"], "name": regs[0]["name"],
                 "start_epoch": regs[0]["start_epoch"],
                 "seeds_reached": len(regs)}
        for k in ("mean_reward", "oracle_reward", "regret"):
            entry[k] = float(np.mean([r[k] for r in regs]))
        recs = [r["recovery_epochs"] for r in regs
                if r["recovery_epochs"] is not None]
        entry["recovery_epochs"] = float(np.mean(recs)) if recs else None
        entry["recovered_seeds"] = len(recs)
        regimes.append(entry)
    out["regimes"] = regimes
    online = [a["online"] for a in per_seed if a.get("online")]
    if online:
        out["online"] = dict(
            online[0],
            updates=float(np.mean([o["updates"] for o in online])),
            triggers=float(np.mean([o["triggers"] for o in online])),
            bursts=float(np.mean([o["bursts"] for o in online])))
    out["per_seed"] = [_strip_series(a) for a in per_seed]
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
    override the scenario without mutating it. ``verbose`` routes the
    narration and the tables through ``obs.info`` (else ``obs.debug``).

    ``timeline=True`` turns on the flight recorder for every simulation
    (``FleetConfig.timeline``): each ``PolicyResult`` carries one
    ``repro_torch.obs.timeline.Timeline`` per seed plus the SLO
    error-budget summaries; results stay bit-identical to a
    recording-off run.
    """
    names = tuple(policies) if policies else scenario.policies
    parsed = [split_policy_name(n) for n in names]
    specs = [get_policy_spec(b) for b, _ in parsed]   # fail fast on typos
    for (base, is_online), spec in zip(parsed, specs):
        if is_online and not spec.trainable:
            raise KeyError(f"policy {base!r} is not trainable; '+online' "
                           "adaptation needs a trainable policy (a2c, ppo)")
    seeds = tuple(seeds) if seeds is not None else scenario.seeds
    n_req = int(n_requests) if n_requests is not None \
        else scenario.n_requests
    eps = int(episodes) if episodes is not None else scenario.episodes

    with obs.span("scenario.build", scenario=scenario.name):
        env_cfg, tables, model_ids, backend_factory = scenario.build_env(device)
        trace = scenario.build_trace()
        schedule = scenario.build_schedule()
        autoscaler = scenario.build_autoscaler()
    fleet = FleetConfig(slo_s=scenario.slo_s, engine=scenario.engine,
                        timeline=timeline,
                        slo_target=scenario.slo_target)

    # verbose routes the narration at info level (console by default);
    # non-verbose runs still record it at debug, so a traced run keeps
    # its story either way
    say = obs.info if verbose else obs.debug
    say(f"scenario {scenario.name}: {scenario.devices} devices "
        f"({scenario.env} env, on {tables.device}), trace={trace.name} "
        f"(mean {trace.mean_rps:.1f} rps/device), "
        f"slo={scenario.slo_s}s, requests={n_req} x seeds {list(seeds)}"
        + (f", drift={schedule.name} "
           f"(boundaries {list(schedule.boundaries)})"
           if schedule else ""))

    results: Dict[str, PolicyResult] = {}
    trained_params: Dict[str, object] = {}   # base name -> pre-drift agent
    header_printed = False
    for name, (base, is_online), spec in zip(names, parsed, specs):
        kw = {}
        if spec.trainable:
            kw = dict(episodes=eps, entropy_coef=scenario.entropy_coef,
                      batch_envs=scenario.batch_envs)
        policy = spec.build(env_cfg, tables, **kw)
        trained, loaded_from, saved_to = False, None, None
        if spec.trainable:
            loaded_from = (load_policies or {}).get(name) \
                or (load_policies or {}).get(base)
            if base in trained_params:
                # the frozen and "+online" variants of one controller
                # share a single pre-drift training run by construction
                policy.set_params(trained_params[base])
                loaded_from = loaded_from or f"(shared: {base})"
                say(f"{name}: sharing {base}'s trained parameters")
            elif loaded_from:
                policy.load(loaded_from)
                say(f"{name}: loaded artifact {loaded_from}")
            else:
                say(f"{name}: training ({eps} episodes) ...")
                with obs.span("scenario.train", policy=name, episodes=eps):
                    hist = policy.train(seed=scenario.train_seed,
                                        trace=scenario.build_train_trace())
                trained = True
                last = np.mean([h["mean_reward"] for h in hist[-15:]])
                say(f"  trained: mean reward (last 15 episodes) = "
                    f"{last:+.3f}")
            shared = base in trained_params and not trained \
                and (loaded_from or "").startswith("(shared")
            trained_params.setdefault(base, policy.params)
            saved_to = (save_policies or {}).get(name) \
                or (save_policies or {}).get(base)
            if saved_to and shared:
                saved_to = None      # the sibling entry owns the artifact
            if saved_to:
                policy.save(saved_to)
                say(f"{name}: saved artifact {saved_to}")

        online_cfg = scenario.build_online(
            algo=getattr(policy, "algo", "a2c")) if is_online else None
        # the learner adapts a copy, so this agent stays the pre-drift one
        snapshot = policy.params if spec.trainable else None
        per_seed, per_adapt, cross = [], [], None
        timelines, per_slo = [], []
        for seed in seeds:
            if is_online and snapshot is not None:
                # every seed adapts from the same pre-drift parameters
                policy.set_params(snapshot)
            with obs.span("scenario.simulate", policy=name, seed=seed):
                res = simulate(env_cfg, tables, policy, trace,
                               n_requests=n_req, seed=seed, fleet=fleet,
                               backend=backend_factory(), model_ids=model_ids,
                               schedule=schedule, online=online_cfg,
                               autoscaler=autoscaler)
            per_seed.append(res.summary)
            if res.adaptation is not None:
                per_adapt.append(res.adaptation)
            if res.timeline is not None:
                timelines.append(res.timeline)
                if res.timeline.slo_report is not None:
                    per_slo.append(res.timeline.slo_report.summary())
            cross = res.cross_check or cross
        if is_online and snapshot is not None:
            policy.set_params(snapshot)      # leave pre-drift params
        mean = {k: float(np.mean([s[k] for s in per_seed]))
                for k in per_seed[0] if k != "unit"}
        slo = None
        if per_slo:
            # seed-mean the scalar fields; time_to_exhaustion may be
            # None (never exhausts) on some seeds: average the rest
            slo_mean = {}
            for k in per_slo[0]:
                vals = [s[k] for s in per_slo
                        if isinstance(s[k], (int, float))]
                slo_mean[k] = float(np.mean(vals)) if vals else None
            slo = {"mean": slo_mean, "per_seed": per_slo}
        results[name] = PolicyResult(
            name=name, mean=mean, per_seed=per_seed, trained=trained,
            loaded_from=loaded_from, saved_to=saved_to, cross_check=cross,
            adaptation=_mean_adaptation(per_adapt) if per_adapt else None,
            slo=slo, timelines=timelines)
        if not header_printed:
            say("\n" + _TABLE_HEADER)
            header_printed = True
        say(results[name].row())

    report = ComparisonReport(scenario=scenario.name, seeds=seeds,
                              n_requests=n_req, trace=trace.name,
                              results=results,
                              schedule=schedule.name if schedule else None)
    if schedule:
        say("\nadaptation metrics (per regime):")
        say(report.adaptation_table())
    return report
