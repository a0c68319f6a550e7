"""repro_torch.obs: structured tracing, metrics, build accounting, the
fleet's flight recorder and learner diagnostics (port of ``repro.obs``:
events, metrics, jaxmon as ``tracemon``, report, slo, timeline,
traindiag).

One process-global recorder (null by default, zero overhead when off)
behind module-level hooks:

    from repro_torch import obs

    with obs.recording("events.jsonl") as rec:      # enable
        with obs.span("fleet.epoch", epoch=0):       # nested timed span
            obs.event("drift.regime_switch", regime=1)
            obs.inc("fleet.dropped", 3, policy="a2c")  # labeled counter

    # -> versioned JSONL; fold with python -m repro_torch.launch.obsview
    #    or obs.report

``obs.log``/``info``/``debug``/``warn`` is the structured console
logger (verbosity-gated print + recorded log events). ``Timeline`` is
the flight recorder ``FleetConfig(timeline=True)`` fills, with its SRE
error-budget report (``SLOConfig``, ``obs.slo``); ``write_timeline``
files render with ``python -m repro_torch.launch.fleetview``.
"""
from repro_torch.obs import report, tracemon
from repro_torch.obs.events import (SCHEMA_VERSION, NullRecorder, Recorder,
                                    debug, event, get_recorder, get_verbosity,
                                    info, log, read_events, recording,
                                    set_recorder, set_verbosity, span, warn)
from repro_torch.obs.metrics import Metrics, gauge, inc, observe
from repro_torch.obs.slo import SLOConfig, SLOReport
from repro_torch.obs.timeline import Timeline, read_timeline, write_timeline
from repro_torch.obs.traindiag import (DIAG_KEYS, TrainDiag, approx_kl,
                                       check_health, explained_variance)

__all__ = [
    "SCHEMA_VERSION", "Recorder", "NullRecorder", "Metrics",
    "span", "event", "recording", "get_recorder", "set_recorder",
    "read_events",
    "inc", "gauge", "observe",
    "log", "info", "debug", "warn", "set_verbosity", "get_verbosity",
    "tracemon", "report", "TrainDiag", "check_health",
    "Timeline", "read_timeline", "write_timeline", "SLOConfig", "SLOReport",
    "DIAG_KEYS", "approx_kl", "explained_variance",
]
