"""repro_torch.obs: structured tracing, metrics, build accounting and
learner diagnostics (port of ``repro.obs``: events, metrics, the
trace-counting half of jaxmon as ``tracemon``, traindiag).

One process-global recorder (null by default, zero overhead when off)
behind module-level hooks:

    from repro_torch import obs

    with obs.recording("events.jsonl") as rec:      # enable
        with obs.span("fleet.epoch", epoch=0):       # nested timed span
            obs.event("drift.regime_switch", regime=1)
            obs.inc("fleet.dropped", 3, policy="a2c")  # labeled counter

``obs.log``/``info``/``debug``/``warn`` is the structured console
logger (verbosity-gated print + recorded log events). The reference's
reporting half (report, slo, timeline) waits for the obs slice.
"""
from repro_torch.obs import tracemon
from repro_torch.obs.events import (SCHEMA_VERSION, NullRecorder, Recorder,
                                    debug, event, get_recorder, get_verbosity,
                                    info, log, read_events, recording,
                                    set_recorder, set_verbosity, span, warn)
from repro_torch.obs.metrics import Metrics, gauge, inc, observe
from repro_torch.obs.traindiag import (DIAG_KEYS, TrainDiag, approx_kl,
                                       check_health, explained_variance)

__all__ = [
    "SCHEMA_VERSION", "Recorder", "NullRecorder", "Metrics",
    "span", "event", "recording", "get_recorder", "set_recorder",
    "read_events",
    "inc", "gauge", "observe",
    "log", "info", "debug", "warn", "set_verbosity", "get_verbosity",
    "tracemon", "TrainDiag", "check_health",
    "DIAG_KEYS", "approx_kl", "explained_variance",
]
