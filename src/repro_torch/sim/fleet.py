"""Discrete-event trace-driven fleet simulator (port of
``repro.sim.fleet``: the ``"loop"`` and ``"vectorized"`` engines over a
single-server world or a server pool, stationary or drifting, with
online adaptation; the ``"scan"`` engine, ``megafleet.simulate_scan``,
over a stationary single-server world on the tables' device; and the
flight recorder on all three).

Each decision epoch (one env slot):

1. the trace delivers per-device request arrivals,
2. the controller policy picks (version, cut) per device from the
   *measured* state (observed arrival rate (EWMA), server queue depth,
   battery, link bandwidth) via ``controller.measured_state``, on the
   tables' device; the actions come back to the host in one copy,
3. the pricing backend turns each action into per-request cost
   constants (head/link/tail times, energy, wire bytes), in numpy,
4. requests flow through a per-device FIFO: the device serializes
   head-compute + transmit per request, so completion times follow the
   Lindley recursion C_k = max(A_k, C_{k-1}) + s, vectorized with a
   running max,
5. offloaded tails add the measured server wait (queue * job service
   time, the env's Eq. 4 term) and feed the server backlog that the
   *next* epoch's controller observes.

Per-request end-to-end latency, SLO attainment, goodput and energy
accumulate in ``FleetMetrics``; device backlogs carry across epochs, so
bursts (MMPP) really queue instead of averaging away.

Cluster worlds (``repro_torch.cluster``): actions carry a server column,
the queue and backlog are per server, each device prices against and
waits behind its routed server, and a ``ServerPool`` meters replica
energy while an optional autoscaler moves replicas and DVFS on the
measured per-server depth.

Nonstationary worlds (``repro_torch.online``): a ``WorldSchedule``
switches the *physics* (pricing config, world-dynamics bounds, trace
scale, battery/churn side effects) at its regime boundaries, while the
controller's observation normalization keeps the base-regime constants
(sensors don't learn the world's config file changed). An
``OnlineConfig`` additionally closes the loop: the fleet captures each
epoch's measured transition, prices its reward under the *current*
regime, and lets an ``OnlineLearner`` incrementally update and hot-swap
the policy's agent mid-run.

Flight recorder (``FleetConfig.timeline``, ``repro_torch.obs.timeline``):
each epoch's recorded latencies, energy, drops and SLO hits, the
per-server depth, DVFS, replicas and power of a pool, and annotations
(regime switches, autoscaler decisions, drift triggers, bursts,
hot-swaps), finished with the SLO error-budget report. Capture only
reads state, so a run gives the same ``SimResult`` with it on or off.

On the host engines the world and the trace draw from numpy PCG64 as in
the reference, so a deterministic policy gives the reference's
``SimResult`` bit for bit, ``adaptation``, ``server_hist`` and the
timeline's columns included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cluster.pool import ServerPool
from repro_torch.core.env import EnvConfig, ProfileTables
from repro_torch.sim import megafleet
from repro_torch.sim.backends import AnalyticalBackend, ExecuteBackend
from repro_torch.sim.metrics import EpochLog, FleetMetrics
from repro_torch.sim.traces import Trace

ENGINES = ("loop", "vectorized", "scan")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    slo_s: float = 1.0            # per-request deadline
    ewma: float = 0.5             # observed arrival-rate smoothing
    max_epochs: int = 100_000
    load_norm_rps: Optional[float] = None   # None -> 2 x trace mean
    # Cap on the queue depth the *controller observes* (jobs). Fleet
    # congestion can push the true queue orders of magnitude past
    # anything the slot-env training distribution contains; an
    # unclipped value drives the policy nets far out of their trained
    # input range. Pricing and metrics always use the true queue.
    queue_obs_clip: float = 25.0
    record_epochs: bool = True
    # epoch-flow engine (repro_torch.sim.megafleet): "loop" walks
    # per-device FIFOs in Python (the parity oracle); "vectorized" runs
    # the same recursion as fused (devices,)-array numpy ops,
    # bit-identical under the same seed; "scan" is one epoch loop of
    # torch ops on the tables' device (float32, histogram percentiles,
    # stationary single-server worlds only)
    engine: str = "loop"
    # epoch_log bounds for mega-fleet horizons: keep every stride-th
    # epoch row, stop after cap rows (None = unbounded)
    log_stride: int = 1
    log_cap: Optional[int] = None
    # flight recorder (repro_torch.obs.timeline): capture per-epoch fleet
    # aggregates, per-server series and annotation events into
    # SimResult.timeline. Off by default; capture only *reads* state, so
    # results stay bit-identical on vs off (tested on every engine).
    # Rows follow log_stride.
    timeline: bool = False
    # SLO attainment objective the error-budget report (repro_torch.obs.
    # slo) burns against; scenarios override it per preset
    slo_target: float = 0.95
    # scan engine only: the reference shards the device axis over every
    # visible accelerator; here one visible card (or the CPU) runs the
    # same program as shard=False. The port has its mesh now
    # (launch.mesh, launch.shardings), but sharding this axis over several
    # cards stays open (ROADMAP section 1, item 5), and several cards raise
    shard: bool = False


@dataclasses.dataclass
class SimResult:
    summary: Dict
    metrics: FleetMetrics
    selection_hist: np.ndarray            # (M, V, K) int64 requests per action
    epochs: int
    served: int
    duration_s: float
    cross_check: Optional[Dict] = None
    epoch_log: object = dataclasses.field(default_factory=list)   # EpochLog
    # drift/adaptation metrics (runs with a schedule or an OnlineConfig):
    # per-regime reward/oracle/regret/recovery + online-learner counters
    adaptation: Optional[Dict] = None
    # cluster runs only: (S,) int64 requests routed to each server
    server_hist: Optional[np.ndarray] = None
    # wall seconds of each epoch's decide: measured_state, act and the
    # actions' copy to the host (the port's own; not in the reference;
    # empty under the scan engine, whose epochs never wait for the host)
    decide_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # flight recorder (FleetConfig.timeline=True): repro_torch.obs.timeline
    # Timeline with per-epoch series, annotations and the SLO report
    timeline: object = None

    @property
    def modal_selection(self):
        h = self.selection_hist
        out = {}
        for mi in range(h.shape[0]):
            if h[mi].sum() > 0:
                j, k = np.unravel_index(np.argmax(h[mi]), h[mi].shape)
                out[mi] = (int(j), int(k))
        return out


def _kinetic_power(pw, activity):
    """The reference's per-device kinetic power (``repro.core.energy.
    kinetic_power`` on float64 numpy activity), value for value: the
    forward/vertical/rotate terms summed in float64, the hover share
    clipped in float32, both added in float32 (JAX's default dtype)."""
    fwd, vert, rot = activity[:, 0], activity[:, 1], activity[:, 2]
    hover = np.clip((1.0 - fwd - vert - rot).astype(np.float32), 0.0, 1.0)
    moving = (fwd * pw.p_forward + vert * pw.p_vertical
              + rot * pw.p_rotate).astype(np.float32)
    return moving + hover * np.float32(pw.p_hover)


def _queues_loop(counts, alive, free_at, pr, srv_wait, t_now,
                 slot_seconds, w_rng, metrics, slo_s):
    """One epoch of request flow, per-device loop (engine="loop").

    The parity oracle for ``megafleet.numpy_queues``: same rng stream
    (offsets drawn unconditionally for every device with arrivals: the
    world-rng draw order must not depend on policy-driven state like
    battery death, or two policies under the same seed would unpair
    mid-run), same recursion, same device-order metric recording.
    Mutates ``free_at`` in place; returns slo_hits.
    """
    slo_hits = 0
    for d in range(counts.shape[0]):
        c = int(counts[d])
        if c == 0:
            continue
        offs = t_now + np.sort(w_rng.uniform(0.0, slot_seconds, c))
        if not alive[d]:
            continue                   # dropped: counted by the caller
        s = pr.head_s[d] + pr.tx_s[d]
        idx = np.arange(c)
        start = np.maximum.accumulate(np.maximum(offs, free_at[d])
                                      - s * idx)
        done = start + s * (idx + 1)       # head+tx completion times
        free_at[d] = done[-1]
        lat = done - offs + pr.tail_s[d]
        if pr.offloaded[d]:
            # scalar (classic single server) or (n,) per-device wait at
            # each device's routed server (cluster mode)
            lat = lat + (srv_wait[d] if np.ndim(srv_wait) else srv_wait)
        metrics.record(lat, np.full(c, pr.energy_j[d]), device=d)
        slo_hits += int(np.sum(lat <= slo_s))
    return slo_hits


def _check_supported(env_cfg, fleet, backend, schedule, online, autoscaler):
    """The reference's checks and refusals, in its words."""
    if fleet.engine not in ENGINES:
        raise ValueError(f"unknown fleet engine {fleet.engine!r}; "
                         f"valid engines: {', '.join(ENGINES)}")
    if fleet.shard and fleet.engine != "scan":
        raise ValueError("FleetConfig.shard requires engine='scan' — the "
                         "host engines have no device axis to shard")
    if env_cfg.cluster is None and autoscaler is not None:
        raise ValueError("autoscaler needs a cluster-mode env "
                         "(EnvConfig.cluster)")
    if fleet.engine == "scan":
        if env_cfg.cluster is not None:
            raise ValueError(
                "engine='scan' compiles the single-server world into one "
                "jitted lax.scan; cluster pools keep per-server state on "
                "the host — use engine='loop' or 'vectorized'")
        if schedule is not None or online is not None:
            raise ValueError(
                "engine='scan' compiles a stationary world into one "
                "jitted lax.scan; drift schedules and online adaptation "
                "need host round-trips — use engine='vectorized'")
        if backend is not None and type(backend) is not AnalyticalBackend:
            raise ValueError(
                "engine='scan' prices on-device through the jnp pricing "
                "core; execute cross-check backends need the host loop")


def simulate(env_cfg: EnvConfig, tables: ProfileTables, policy,
             trace: Trace, *, n_requests: int = 100_000, seed: int = 0,
             fleet: FleetConfig = FleetConfig(),
             backend: Optional[AnalyticalBackend] = None,
             model_ids: Optional[Sequence[int]] = None,
             schedule=None, online=None, autoscaler=None) -> SimResult:
    """Run the fleet until ``n_requests`` have arrived (or max_epochs).

    Cluster mode (``env_cfg.cluster`` set): actions carry a server
    column, the queue/backlog state is per-server, pricing runs against
    each device's *chosen* target, and an optional ``autoscaler``
    (``repro_torch.cluster.AutoscalerConfig``) moves replicas/DVFS per
    epoch on the measured per-server queue depth (replica energy and scale
    events land in the summary). A 1-server pool at uniform topology is
    bit-identical to the classic path.

    ``policy`` is a ``repro_torch.policies.Policy`` built against this
    same (env_cfg, tables) world: ``act(state, generator) -> (n, 2)``
    ((n, 3) in cluster mode) on the tables' device. Each epoch it gets the
    measured state and a host ``torch.Generator`` seeded with ``seed``,
    which only sampling (and exploring) policies read: their draws are
    made on the host and copied to the card, so a run on the card draws
    what the CPU run draws.

    ``schedule`` (``repro_torch.online.WorldSchedule``) switches the
    physics regime at its patch epochs; ``online``
    (``repro_torch.online.OnlineConfig``) enables closed-loop adaptation
    of a trainable policy. Either one turns on per-regime adaptation
    metrics (``SimResult.adaptation``).

    The trace and the world dynamics draw from independent numpy
    generators spawned off one seed, and the draw order is
    policy-independent (drift patches and trace scaling fire on the
    epoch clock, never on policy-driven state), so two policies simulated
    with the same seed face the *identical* request stream, and the whole
    run, online updates included, is bit-reproducible.
    """
    from repro_torch.core import pricing
    from repro_torch.core.controller import measured_state

    if policy.env_cfg is not env_cfg or policy.tables is not tables:
        raise ValueError(
            f"policy {policy.name!r} was built against a different "
            "(env_cfg, tables) world than this simulation; its decisions "
            "would silently score under the wrong physics; build it from "
            "the same objects (run_scenario does this for you)")
    _check_supported(env_cfg, fleet, backend, schedule, online, autoscaler)
    if fleet.engine == "scan":
        return megafleet.simulate_scan(
            env_cfg, tables, policy, trace, n_requests=n_requests,
            seed=seed, fleet=fleet, model_ids=model_ids)
    cfg = env_cfg
    n = cfg.n_uavs
    backend = backend if backend is not None else AnalyticalBackend(cfg, tables)
    if model_ids is None:
        model_ids = np.arange(n, dtype=np.int32) % tables.n_models
    model_ids = np.asarray(model_ids, dtype=np.int32)

    # -- nonstationarity + online adaptation --------------------------------
    regimes, learner, tracker, np_t = None, None, None, None
    if schedule is not None:
        if isinstance(backend, ExecuteBackend):
            raise ValueError("drift schedules price through the analytical "
                             "backend; the execute cross-check assumes one "
                             "stationary table world")
        # compile() caches one AnalyticalBackend per patched regime, so
        # switches inside the epoch loop never rebuild table snapshots
        regimes = schedule.compile(cfg, tables)
    if online is not None or schedule is not None:
        from repro_torch.online.monitor import AdaptationTracker, oracle_reward
        tracker = AdaptationTracker()
        np_t = pricing.numpy_tables(tables)
    if online is not None:
        from repro_torch.online.adapt import OnlineLearner
        learner = OnlineLearner(policy, online, model_ids)
    regime_idx = 0
    reg = regimes[0] if regimes else None
    phys = cfg                    # current regime's physics config
    phys_backend = backend
    lp, pw = phys.latency, phys.power

    ss = np.random.SeedSequence(seed)
    s_trace, s_world = ss.spawn(2)
    t_rng = np.random.default_rng(s_trace)
    w_rng = np.random.default_rng(s_world)
    # decide-time draws (sampling and exploring policies) on the host, so
    # a run on the card draws what the same run on the CPU draws
    generator = torch.Generator().manual_seed(seed)

    # world state (mirrors env_reset means, drawn from the world rng)
    battery = np.full(n, pw.battery_j)
    bw = w_rng.uniform(lp.bw_min_bps, lp.bw_max_bps, n)
    p_tx = w_rng.uniform(pw.p_tx_min, pw.p_tx_max, n)
    activity = np.tile(np.asarray(cfg.activity, dtype=np.float64), (n, 1))
    cluster = cfg.cluster
    pool = None
    srv_hist = None
    if cluster is not None:
        link_scale = np.asarray(cluster.link_scale, dtype=np.float64)
        link_rtt_s = np.asarray(cluster.link_rtt_s, dtype=np.float64)
        if link_scale.shape != (n, cluster.n_servers):
            raise ValueError(
                f"cluster topology is {link_scale.shape} (devices x "
                f"servers) but this fleet is ({n}, {cluster.n_servers})")
        pool = ServerPool(cluster, autoscaler)
        srv_hist = np.zeros(cluster.n_servers, dtype=np.int64)
        side_queue = np.zeros(cluster.n_servers)   # per-server bg jobs
        backlog_s = np.zeros(cluster.n_servers)    # per-server tail work
    else:
        side_queue = 0.0      # env-style background jobs on the server
        backlog_s = 0.0       # fleet-induced tail work awaiting service
    free_at = np.zeros(n)     # absolute time each device drains its FIFO
    obs_rate = np.full(n, trace.mean_rps)
    # load normalization must match what the controller trained on:
    # cfg.peak_rps when the stability-aware env is in play, else a
    # 2x-mean heuristic for paper-faithful (Bernoulli-task) policies.
    # Fixed at the base regime: the controller's sensor calibration does
    # not track drift.
    norm_rps = fleet.load_norm_rps or (
        cfg.peak_rps if cfg.peak_rps > 0 else max(2.0 * trace.mean_rps,
                                                  1e-9))

    stream = trace.stream(t_rng, n, cfg.slot_seconds)
    metrics = FleetMetrics(slo_s=fleet.slo_s)
    tl = None
    if fleet.timeline:
        from repro_torch.obs.timeline import Timeline
        tl = Timeline(slo_s=fleet.slo_s, slot_seconds=cfg.slot_seconds,
                      stride=fleet.log_stride,
                      n_servers=0 if cluster is None else cluster.n_servers,
                      server_names=None if cluster is None
                      else list(cluster.names),
                      engine=fleet.engine)
    hist = np.zeros((tables.n_models, tables.n_versions, tables.n_cuts),
                    dtype=np.int64)
    epoch_log = EpochLog(stride=fleet.log_stride, cap=fleet.log_cap)
    decide_s = []
    served = 0
    epoch = 0
    t_now = 0.0

    while served < n_requests and epoch < fleet.max_epochs:
      with obs.span("fleet.epoch", epoch=epoch, regime=regime_idx):
        counts = np.asarray(next(stream), dtype=np.int64)

        # -- regime switch (epoch-clock driven, policy-independent) --------
        if regimes is not None:
            r = schedule.regime_at(epoch)
            if r != regime_idx:
                regime_idx, reg = r, regimes[r]
                obs.event("drift.regime_switch", epoch=epoch,
                          regime=regime_idx, name=reg.name)
                if tl is not None:
                    tl.annotate(epoch, "regime_switch",
                                regime=regime_idx, name=reg.name)
                phys = reg.env_cfg
                lp, pw = phys.latency, phys.power
                phys_backend = backend if phys is cfg \
                    else (reg.backend or AnalyticalBackend(phys, tables))
                if reg.battery_scale is not None:
                    battery = battery * reg.battery_scale
                for d in reg.kill_devices:
                    battery[d] = 0.0
                for d in reg.revive_devices:
                    battery[d] = pw.battery_j
                    free_at[d] = t_now
                # world variables snap into the new regime's bounds
                bw = np.clip(bw, lp.bw_min_bps, lp.bw_max_bps)
                p_tx = np.clip(p_tx, pw.p_tx_min, pw.p_tx_max)
            if reg.trace_scale != 1.0:
                from repro_torch.online.drift import scale_counts
                counts = np.asarray(
                    scale_counts(t_rng, counts, reg.trace_scale),
                    dtype=np.int64)

        alive = battery > 0.0
        if not alive.any():
            break
        if pool is None:
            queue_jobs = side_queue + backlog_s / lp.job_service_s
            srv_wait = queue_jobs * lp.job_service_s
            obs_queue = min(queue_jobs, fleet.queue_obs_clip)
        else:
            # live per-server service arrays at the pool's current
            # replica/DVFS state under the current regime's physics
            eff = pool.effective(lp, phys)
            queue_jobs = side_queue + backlog_s / eff.service_s
            srv_wait_s = queue_jobs * eff.service_s       # (S,)
            obs_queue = np.minimum(queue_jobs, fleet.queue_obs_clip)
        load = np.clip(obs_rate / norm_rps, 0.0, 1.0)

        # 1) decide from measured state (obs normalization: base regime),
        #    on the tables' device; one copy of the actions to the host
        with obs.span("fleet.decide", policy=policy.name):
            t_decide = time.perf_counter()
            state = measured_state(
                cfg, tables, battery_j=battery, bandwidth=bw, p_tx=p_tx,
                queue_jobs=obs_queue, load=load,
                model_id=model_ids, activity=activity, t=epoch)
            actions = policy.act(state, generator).cpu().numpy()
            decide_s.append(time.perf_counter() - t_decide)

        # 2) price this epoch's actions under the current regime
        if pool is None:
            pr = phys_backend.price(model_ids, actions, bw, p_tx)
        else:
            pr = phys_backend.price(
                model_ids, actions, bw, p_tx, srv_flops=eff.flops,
                srv_service_s=eff.service_s, link_scale=link_scale,
                link_rtt_s=link_rtt_s)
            # each device waits behind its *routed* server's queue
            srv_wait = srv_wait_s[actions[:, 2]]

        # 3) flow requests through device FIFOs (Lindley recursion).
        # Everything outside the queueing recursion itself is shared by
        # both engines as vectorized expressions: same float summation
        # order, so the engines stay bit-identical.
        sel = alive & (counts > 0)
        dropped = int(counts[~alive].sum())
        if dropped:
            metrics.drop(dropped)
        contrib = np.where(sel & pr.offloaded, counts * pr.tail_s, 0.0)
        if pool is None:
            tail_in_s = float(contrib.sum())
        else:
            # per-server sums via mask-compress (same pairwise summation
            # order as the classic .sum(), so S == 1 stays bit-equal)
            routed = actions[:, 2]
            tail_in_s = np.array([contrib[routed == s].sum()
                                  for s in range(cluster.n_servers)])
        queues = megafleet.numpy_queues if fleet.engine == "vectorized" else _queues_loop
        mark = metrics.mark() if tl is not None else None
        with obs.span("fleet.queues", engine=fleet.engine):
            slo_hits = queues(counts, alive, free_at, pr, srv_wait, t_now,
                              cfg.slot_seconds, w_rng, metrics, fleet.slo_s)
        # one scatter-add per epoch instead of a per-device increment
        np.add.at(hist, (model_ids[sel], actions[sel, 0],
                         actions[sel, 1]), counts[sel])
        if pool is not None:
            np.add.at(srv_hist, actions[sel, 2], counts[sel])
        if sel.any():
            d0 = int(np.argmax(sel))
            phys_backend.maybe_execute(int(model_ids[d0]), int(actions[d0, 0]),
                                       int(actions[d0, 1]))

        # 3b) adaptation metrics + online update: the epoch's slot-level
        # reward (Eq. 8 over the measured view) priced under the CURRENT
        # regime, and the greedy oracle re-solved under the same regime
        if tracker is not None:
          with obs.span("fleet.adapt"):
            vkw = {} if pool is None else dict(
                srv_flops=eff.flops, srv_service_s=eff.service_s,
                link_scale=link_scale, link_rtt_s=link_rtt_s)
            view = pricing.StateView(
                model_id=model_ids, bandwidth=bw, p_tx=p_tx,
                queue=obs_queue, load=load, **vkw)
            br = pricing.price_actions(phys, np_t, view, actions, xp=np)
            wts = phys.weights
            per = (wts.w_acc * br.acc_score + wts.w_lat * br.lat_score
                   + wts.w_energy * br.energy_score
                   + wts.w_stab * br.stab_score)
            amask = alive.astype(np.float64)
            r_epoch = float((per * amask).sum() / max(amask.sum(), 1.0))
            oracle_r = oracle_reward(phys, np_t, view, amask)
            tracker.record(epoch, regime_idx,
                           reg.name if reg is not None else "base",
                           r_epoch, oracle_r)
            if learner is not None:
                on0 = (learner.updates, learner.bursts,
                       learner.monitor.triggers)
                learner.observe_transition(state, actions, per, amask,
                                           regime_idx)
                swapped = learner.step(epoch, r_epoch,
                                       oracle_reward=oracle_r)
                if tl is not None:
                    # counter deltas -> annotation events (the learner
                    # already emitted the matching online.* obs events)
                    if learner.monitor.triggers > on0[2]:
                        tl.annotate(epoch, "drift_trigger")
                    if learner.bursts > on0[1]:
                        tl.annotate(epoch, "burst_start")
                    if swapped:
                        tl.annotate(epoch, "hotswap",
                                    updates=learner.updates)

        # 4) world dynamics (mirrors env_step, on the world rng, under
        #    the current regime's latency/power bounds)
        with obs.span("fleet.dynamics"):
            kin_p = _kinetic_power(pw, activity)
            drain = np.where(alive, kin_p * cfg.slot_seconds
                             + counts * pr.energy_j, 0.0)
            battery = np.maximum(battery - drain, 0.0)
            bw = np.clip(bw * np.exp(w_rng.normal(size=n) * 0.15),
                         lp.bw_min_bps, lp.bw_max_bps)
            p_tx = np.clip(p_tx + w_rng.normal(size=n) * 0.05,
                           pw.p_tx_min, pw.p_tx_max)
            activity = np.clip(activity + w_rng.normal(size=(n, 3))
                               * cfg.activity_jitter, 0.0, 1.0)
            activity /= np.maximum(activity.sum(-1, keepdims=True), 1.0)
            if pool is None:
                side_queue = max(
                    side_queue + float(w_rng.poisson(phys.queue_arrival_rate))
                    - phys.queue_service_per_slot, 0.0)
                backlog_s = max(backlog_s + tail_in_s - cfg.slot_seconds, 0.0)
            else:
                # one scalar Poisson per server, in server order: at
                # S == 1 with unit scale both the lam and the PCG64
                # stream position match the classic draw bitwise
                arr = np.array([float(w_rng.poisson(
                    phys.queue_arrival_rate * cluster.bg_arrival_scale[s]))
                    for s in range(cluster.n_servers)])
                side_queue = np.maximum(side_queue + arr - eff.bg_drain, 0.0)
                backlog_s = np.maximum(
                    backlog_s + tail_in_s - cfg.slot_seconds * eff.cap_scale, 0.0)
                pool.tick(queue_jobs, cfg.slot_seconds)
                for dec in pool.last_decisions:
                    obs.event("autoscale.decision", epoch=epoch, **dec)
                    if tl is not None:
                        tl.annotate(epoch, "autoscale", **dec)
            obs_rate = (1.0 - fleet.ewma) * obs_rate \
                + fleet.ewma * counts / cfg.slot_seconds

        served += int(counts.sum())
        t_now += cfg.slot_seconds
        obs.inc("fleet.arrivals", int(counts.sum()), policy=policy.name)
        if dropped:
            obs.inc("fleet.dropped", dropped, policy=policy.name)
        obs.inc("fleet.slo_hits", slo_hits, policy=policy.name)
        obs.observe("fleet.queue_jobs",
                    queue_jobs if pool is None else float(queue_jobs.sum()),
                    policy=policy.name)
        if tl is not None:
            with obs.span("fleet.timeline"):
                lat_e, en_e = metrics.since(mark)
                tl.append_epoch(
                    epoch=epoch, arrivals=int(counts.sum()),
                    dropped=dropped, slo_hits=slo_hits,
                    alive=int(alive.sum()), regime=regime_idx,
                    queue_jobs=float(np.sum(queue_jobs)),
                    backlog_s=float(np.sum(backlog_s)),
                    lat=lat_e, energy_j=float(en_e.sum()),
                    # per-server series: measured depth at decision time
                    # + the DVFS/replica/power state this epoch ran at
                    # (pool.tick snapshots before the autoscaler moves)
                    srv_queue=None if pool is None else queue_jobs,
                    srv_dvfs=None if pool is None else pool.last_dvfs,
                    srv_replicas=None if pool is None
                    else pool.last_replicas,
                    srv_power_w=None if pool is None
                    else pool.last_power_w)
        if fleet.record_epochs:
            epoch_log.append({
                "epoch": epoch, "arrivals": int(counts.sum()),
                # cluster rows log totals (the classic path's scalar schema)
                "queue_jobs": float(np.sum(queue_jobs)),
                "backlog_s": float(np.sum(backlog_s)),
                "dropped": dropped, "slo_hits": slo_hits,
                "alive": int(alive.sum()), "regime": regime_idx,
            })
        epoch += 1

    adaptation = None
    if tracker is not None:
        adaptation = tracker.summary(include_series=fleet.record_epochs)
        adaptation["schedule"] = schedule.name if schedule is not None \
            else None
        if learner is not None:
            adaptation["online"] = learner.summary()
            # leave the policy in its serving (greedy) mode
            if hasattr(policy, "set_explore"):
                policy.set_explore(0.0)

    if tl is not None:
        from repro_torch.obs.slo import SLOConfig
        tl.finalize(SLOConfig(target=fleet.slo_target))
    summary = metrics.summary(duration_s=t_now)
    summary["epochs"] = epoch
    summary["requests"] = served
    if pool is not None:
        summary.update(pool.summary())
    return SimResult(summary=summary, metrics=metrics, selection_hist=hist,
                     epochs=epoch, served=served, duration_s=t_now,
                     cross_check=backend.cross_check(), epoch_log=epoch_log,
                     adaptation=adaptation, server_hist=srv_hist,
                     decide_s=np.asarray(decide_s), timeline=tl)
