"""Structured observability of the port: event bus, span timing, and the
plan-vs-runtime drift monitor (counterpart of ``repro/obs``):

* :mod:`repro_torch.obs.bus` -- the event/metric bus. Every telemetry
  record is one flat JSON object; sinks decide where it goes (crash-safe
  append-mode JSONL, stdout in the reference's wire format, an in-memory
  list for tests). Counters (guard skips, escalations, checkpoint
  fallbacks, NS dispatches) accumulate on the bus and ride out in the
  ``run_end`` record.
* :mod:`repro_torch.obs.spans` -- host-side span timers (step /
  checkpoint / resume, nested with parent attribution) and
  ``torch.profiler`` stage annotations.
* :mod:`repro_torch.obs.drift` -- the drift monitor: joins the comm plan's
  predicted bytes per link class against measured block and full step
  walls (:class:`DriftMonitor`), or per residue of the staggered schedule
  (:class:`ResidueDriftMonitor`), and emits a ``drift`` event when the
  modeled rates (``distributed.plan.MODELED_LINK_BYTES_PER_S``, planning
  constants, not a measurement) disagree with the run beyond a threshold.

``python -m repro_torch.scripts.obs_report`` aggregates a run's JSONL.
"""

from repro_torch.obs.bus import (  # noqa: F401
    Bus,
    EVENT_FIELDS,
    JsonlSink,
    MemorySink,
    QUIET_EVENTS,
    StdoutSink,
    event_type,
    get_bus,
    set_bus,
    validate_record,
)
from repro_torch.obs.spans import (  # noqa: F401
    Span,
    percentiles,
    record_span,
    span,
    stage_scope,
)

# Last: drift imports the distributed plan, whose package imports the
# engine, which imports the names above.
from repro_torch.obs.drift import (  # noqa: F401,E402
    DriftConfig,
    DriftMonitor,
    ResidueDriftMonitor,
    exposed_by_link,
)
