"""Structured observability of the port: event bus and span timing.

Counterpart of ``repro/obs`` without its drift monitor (``obs/drift.py``
prices collectives from the distributed plan, which the port does not have
yet):

* :mod:`repro_torch.obs.bus` -- the event/metric bus. Every telemetry
  record is one flat JSON object; sinks decide where it goes (crash-safe
  append-mode JSONL, stdout in the reference's wire format, an in-memory
  list for tests). Counters (guard skips, escalations, checkpoint
  fallbacks, NS dispatches) accumulate on the bus and ride out in the
  ``run_end`` record.
* :mod:`repro_torch.obs.spans` -- host-side span timers (step /
  checkpoint / resume, nested with parent attribution) and
  ``torch.profiler`` stage annotations.

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
    span,
    stage_scope,
)
