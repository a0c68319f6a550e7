"""Regime-switching world model: timed EnvPatches over a running fleet
(port of ``repro.online.drift``, numpy).

EdgeRL's premise is inference tuning in *ad-hoc* edge environments, yet
a stationary EnvConfig can never exercise the paper's core claim of
re-aligning (version, cut) decisions as conditions change. A
``WorldSchedule`` is a sequence of timed ``EnvPatch``es that mutate
EnvConfig fields mid-run (link-bandwidth brownout, battery decay/cliff,
server slowdown, flash-crowd rate shifts, device churn), and
``compile()`` resolves them into per-regime ``Regime`` records the fleet
loop switches between at epoch boundaries.

One patch, three consistent views of the shifted physics:

- the **torch env**: ``Regime.env_cfg`` is a full EnvConfig, so training
  rollouts, ``env.action_costs`` and ``baselines.greedy_oracle`` price
  the regime exactly;
- the **numpy pricing snapshot**: the fleet loop prices each regime
  through an ``AnalyticalBackend`` built from the same
  ``Regime.env_cfg``;
- the **trace stream**: ``Regime.trace_scale`` thins (binomial) or
  augments (conditional Poisson) the per-epoch arrival counts through
  ``scale_counts``, drawn from the fleet's trace rng in a
  policy-independent order, so paired seeds stay paired under drift.

Observation semantics: the controller's *sensors* keep the base-regime
normalization constants (a deployed policy does not learn that the
world's config file changed); only the physics (pricing, reward,
dynamics) follow the patched config. That split is what makes drift
detectable from the reward stream (``repro_torch.online.monitor``)
rather than trivially visible in the features.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnvPatch:
    """One timed mutation of the operating regime.

    ``env`` sets EnvConfig fields to absolute values and ``env_scale``
    multiplies them; keys are dotted paths into the nested frozen
    dataclasses (``"latency.bw_max_bps"``, ``"power.p_compute"``,
    ``"peak_rps"``). ``reset=True`` starts from the *base* config again
    before applying this patch's own updates (regime recovery).

    World-state side effects applied once at the boundary:
    ``battery_scale`` multiplies every device's remaining charge (decay
    cliff), ``kill_devices`` zeroes the listed batteries (churn out),
    ``revive_devices`` restores listed devices to a full battery (churn
    in). ``trace_scale`` multiplies the offered arrival rate from this
    patch onward (``None`` inherits the previous regime's scale).
    """
    at_epoch: int
    name: str = ""
    env: Mapping[str, float] = dataclasses.field(default_factory=dict)
    env_scale: Mapping[str, float] = dataclasses.field(default_factory=dict)
    reset: bool = False
    trace_scale: Optional[float] = None
    battery_scale: Optional[float] = None
    kill_devices: Tuple[int, ...] = ()
    revive_devices: Tuple[int, ...] = ()


def _patch_path(cfg, path: str, value):
    """Functional set of one dotted field path on nested frozen
    dataclasses; unknown segments fail loudly (a silently ignored patch
    would simulate the wrong physics)."""
    head, _, rest = path.partition(".")
    if not dataclasses.is_dataclass(cfg) or not any(
            f.name == head for f in dataclasses.fields(cfg)):
        valid = [f.name for f in dataclasses.fields(cfg)] \
            if dataclasses.is_dataclass(cfg) else []
        raise KeyError(f"EnvPatch path {path!r}: no field {head!r} on "
                       f"{type(cfg).__name__} (has {sorted(valid)})")
    cur = getattr(cfg, head)
    new = _patch_path(cur, rest, value) if rest else value
    return dataclasses.replace(cfg, **{head: new})


def apply_env_patch(cfg, patch: EnvPatch):
    """Apply ``patch.env`` / ``patch.env_scale`` to an EnvConfig."""
    for path, value in patch.env.items():
        cfg = _patch_path(cfg, path, value)
    for path, factor in patch.env_scale.items():
        cur = cfg
        for seg in path.split("."):
            cur = getattr(cur, seg)
        cfg = _patch_path(cfg, path, cur * factor)
    return cfg


@dataclasses.dataclass(frozen=True)
class Regime:
    """One resolved operating regime: [start_epoch, next boundary)."""
    index: int
    start_epoch: int
    name: str
    env_cfg: object
    trace_scale: float = 1.0
    battery_scale: Optional[float] = None     # applied once on entry
    kill_devices: Tuple[int, ...] = ()
    revive_devices: Tuple[int, ...] = ()
    # pricing backend cached at compile() time for patched-config
    # regimes (None when env_cfg is the caller's base config — the
    # fleet then reuses its own backend). Excluded from equality/repr:
    # it is a derived cache, not part of the regime's identity.
    backend: object = dataclasses.field(default=None, compare=False,
                                        repr=False)


@dataclasses.dataclass(frozen=True)
class WorldSchedule:
    """Ordered timed patches; epoch 0 is the unpatched base regime."""
    patches: Tuple[EnvPatch, ...]
    name: str = "schedule"

    def __post_init__(self):
        object.__setattr__(self, "patches", tuple(self.patches))
        epochs = [p.at_epoch for p in self.patches]
        if any(e <= 0 for e in epochs):
            raise ValueError("EnvPatch.at_epoch must be > 0 (epoch 0 is "
                             "the base regime)")
        if epochs != sorted(set(epochs)):
            raise ValueError(f"patch epochs must be strictly increasing; "
                             f"got {epochs}")

    @property
    def n_regimes(self) -> int:
        return len(self.patches) + 1

    @property
    def boundaries(self) -> Tuple[int, ...]:
        return tuple(p.at_epoch for p in self.patches)

    def regime_at(self, epoch: int) -> int:
        i = 0
        for p in self.patches:
            if epoch >= p.at_epoch:
                i += 1
        return i

    def compile(self, base_cfg, tables=None) -> List[Regime]:
        """Resolve patches cumulatively into per-regime records. Each
        patch applies on top of the previous regime's config (or the
        base config under ``reset=True``); ``trace_scale`` inherits.

        With ``tables``, each patched-config regime also carries a
        ready ``AnalyticalBackend`` (one numpy table snapshot per
        regime, built here once) so the fleet's regime switches inside
        the epoch loop never rebuild pricing state. Regimes whose
        config *is* ``base_cfg`` (pure resets) leave ``backend=None``
        and price through the fleet's own backend."""
        def make_backend(cfg):
            if tables is None or cfg is base_cfg:
                return None
            from repro_torch.sim.backends import AnalyticalBackend
            return AnalyticalBackend(cfg, tables)

        regimes = [Regime(index=0, start_epoch=0, name="base",
                          env_cfg=base_cfg)]
        cfg, scale = base_cfg, 1.0
        for i, p in enumerate(self.patches):
            if p.reset:
                cfg, scale = base_cfg, 1.0
            cfg = apply_env_patch(cfg, p)
            if p.trace_scale is not None:
                scale = float(p.trace_scale)
            regimes.append(Regime(
                index=i + 1, start_epoch=p.at_epoch,
                name=p.name or f"regime{i + 1}", env_cfg=cfg,
                trace_scale=scale, battery_scale=p.battery_scale,
                kill_devices=tuple(p.kill_devices),
                revive_devices=tuple(p.revive_devices),
                backend=make_backend(cfg)))
        return regimes


def scale_counts(rng: np.random.Generator, counts: np.ndarray,
                 scale: float) -> np.ndarray:
    """Scale a per-device arrival-count draw to ``scale``x the offered
    rate: binomial thinning for scale < 1 (exact for Poisson arrivals),
    a conditional-Poisson augmentation for scale > 1 (mean lambda*scale
    given the base draw; slightly over-dispersed, which only makes a
    flash crowd burstier). Draws come from the caller's trace rng in an
    epoch-indexed, policy-independent order, so two policies under one
    seed still face the identical shifted request stream."""
    if scale == 1.0:
        return counts
    if scale < 0:
        raise ValueError(f"trace_scale must be >= 0, got {scale}")
    if scale < 1.0:
        return rng.binomial(counts, scale)
    return counts + rng.poisson(counts * (scale - 1.0))


# --------------------------------------------------------------------------
# named schedule factories (the nonstationary preset worlds)
# --------------------------------------------------------------------------

def link_brownout(onset: int = 60, recover: int = 220,
                  bw_max_bps: float = 6e6, bw_min_bps: float = 3e6,
                  server_scale: float = 0.1) -> WorldSchedule:
    """Edge-infrastructure brownout: the uplink collapses below the
    design-time floor and the edge server's effective share degrades
    with it (congested backhaul), then the world recovers."""
    patches = [EnvPatch(
        at_epoch=onset, name="brownout",
        env={"latency.bw_max_bps": bw_max_bps,
             "latency.bw_min_bps": bw_min_bps},
        env_scale={"latency.server_flops": server_scale,
                   "queue_service_per_slot": server_scale})]
    if recover:
        patches.append(EnvPatch(at_epoch=recover, name="recovered",
                                reset=True))
    return WorldSchedule(tuple(patches), name="link-brownout")


def battery_cliff(at: int = 70, battery_scale: float = 0.25,
                  compute_scale: float = 3.0,
                  recover: int = 0) -> WorldSchedule:
    """Battery decay cliff: remaining charge drops to ``battery_scale``
    of nominal at once and degraded cells draw ``compute_scale``x the
    compute power thereafter."""
    patches = [EnvPatch(at_epoch=at, name="cliff",
                        env_scale={"power.p_compute": compute_scale},
                        battery_scale=battery_scale)]
    if recover:
        patches.append(EnvPatch(at_epoch=recover, name="recovered",
                                reset=True))
    return WorldSchedule(tuple(patches), name="battery-cliff")


def flash_crowd(onset: int = 60, relax: int = 220, scale: float = 4.0,
                peak_rps: Optional[float] = None,
                queue_scale: float = 6.0) -> WorldSchedule:
    """Flash crowd: offered arrival rate jumps to ``scale``x and the
    shared server's background workload surges with it. ``peak_rps``
    re-calibrates the stability term's saturation rate for the crowd
    regime (the operator knows the crowd is on)."""
    env = {"peak_rps": peak_rps} if peak_rps is not None else {}
    patches = [EnvPatch(at_epoch=onset, name="crowd", env=env,
                        env_scale={"queue_arrival_rate": queue_scale},
                        trace_scale=scale)]
    if relax:
        patches.append(EnvPatch(at_epoch=relax, name="relaxed",
                                reset=True))
    return WorldSchedule(tuple(patches), name="flash-crowd")


def device_churn(leave_at: int = 60, rejoin_at: int = 160,
                 leave: Tuple[int, ...] = (0, 1)) -> WorldSchedule:
    """Device churn: the listed devices drop out of the fleet (battery
    dead, requests dropped) and later rejoin with fresh batteries."""
    patches = [EnvPatch(at_epoch=leave_at, name="churn-out",
                        kill_devices=tuple(leave))]
    if rejoin_at:
        patches.append(EnvPatch(at_epoch=rejoin_at, name="churn-in",
                                revive_devices=tuple(leave)))
    return WorldSchedule(tuple(patches), name="device-churn")


SCHEDULES: Dict[str, object] = {
    "link-brownout": link_brownout,
    "battery-cliff": battery_cliff,
    "flash-crowd": flash_crowd,
    "device-churn": device_churn,
}


def schedule_names() -> Tuple[str, ...]:
    return tuple(sorted(SCHEDULES))


def get_schedule(name: str, **kw) -> WorldSchedule:
    """Canonical-name lookup; a miss names every valid schedule (same
    convention as the policy/scenario/trace registries)."""
    if name not in SCHEDULES:
        raise KeyError(f"unknown drift schedule {name!r}; valid names: "
                       f"{', '.join(schedule_names())}")
    return SCHEDULES[name](**kw)
