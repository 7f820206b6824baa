"""Event/metric bus with pluggable sinks (copy of ``repro/obs/bus.py``).

Framework-free; the port keeps its own copy so that it imports nothing of
the reference package. Records, sinks, the stdout wire format,
:data:`QUIET_EVENTS` and the schema registry are the reference's, so a
trail written by either package reads the same.

A telemetry record is one flat JSON-serializable dict. Typed events carry
an ``"event"`` key; per-step training records keep the legacy shape
(``{"step": ..., "loss": ...}`` with no ``"event"`` key) so every stdout
parser (``repro_torch.scripts.chaos_run`` above all) keeps working.
:func:`event_type` recovers the logical type either way.

Sinks:

* :class:`JsonlSink` -- crash-safe append-mode JSONL. Mirrors
  ``training/checkpoint.py``'s durability discipline: every record is
  flushed and ``os.fsync``'d before ``emit`` returns, so a SIGKILL (as
  injected by ``training/faults.py``) loses at most the record being
  written, never previously emitted ones. A kill mid-write can leave one
  torn final line; readers (:func:`read_jsonl`,
  ``repro_torch.scripts.obs_report``) tolerate exactly that.
* :class:`StdoutSink` -- prints ``json.dumps(record)`` verbatim, minus the
  high-volume event types in :data:`QUIET_EVENTS`.
* :class:`MemorySink` -- list of records, for tests.

Ordering matters: the launcher registers the JSONL sink *before* stdout,
so any record a parser saw on stdout is already durable on disk -- the
containment invariant ``repro_torch.scripts.chaos_run`` asserts after each
kill.

The bus also carries monotonic counters (:meth:`Bus.inc`) for the
guard/escalator ladder (skips, forced-full steps, lr backoffs, checkpoint
fallbacks) and NS dispatch counts. Counters are plain host ints:
incrementing one never touches a device value.
"""

from __future__ import annotations

import io
import json
import os
import sys
import time
from typing import Any, Callable

# Event types kept off stdout by default: high-volume or report-only
# records that would swamp the human-facing log. Everything else --
# checkpoint/resume/abort/skip_snapshot, drift, escalation, and the
# legacy per-step records -- stays on stdout exactly as before.
QUIET_EVENTS = (
    "span",
    "run_start",
    "run_end",
    "counters",
    "comm_rates",
    "dryrun_combo",
    "perf_record",
    "schedule",
    "serve_step",
)

# Schema registry: required fields per event type, the reference's own (so
# one registry validates trails of either package). ``obs_report`` validates
# against it in --strict mode. The legacy per-step record (no "event" key)
# is registered as "step".
EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    # "residue" is the step's position in the MuonBP period (step % P; 0
    # when no period applies) and "due" the number of muon leaves running
    # their full-orthogonalization path this step -- the whole set on a
    # synchronous full step, the residue's offset group under
    # --full-schedule staggered, 0 on pure block steps. The full
    # offset->leaf mapping is emitted once per run in the "schedule" event.
    "step": ("step", "loss", "phase", "residue", "due"),
    "span": ("name", "dur_s"),
    "run_start": ("argv",),
    "schedule": ("mode", "period"),
    "run_end": ("steps", "wall_s", "status", "counters"),
    "checkpoint": ("step", "path"),
    "skip_snapshot": ("path", "why"),
    "resume": ("step", "snapshot"),
    "abort": ("step",),
    "escalation": ("step", "action"),
    "drift": ("step", "ratio", "measured_extra_s", "modeled_extra_s"),
    "comm_rates": ("modeled_bytes_per_s", "achieved_bytes_per_s"),
    "counters": ("counters",),
    "dryrun_combo": ("phase", "lower_s", "compile_s"),
    "perf_record": ("name",),
    # Serving-engine lifecycle (the reference's serving engine). Latencies
    # are virtual-clock seconds.
    "admit": ("request", "tenant", "blocks", "queue_wait_s"),
    "reject": ("request", "tenant", "reason"),
    "shed": ("request", "tenant", "reason"),
    "cancel": ("request", "tenant", "reason", "tokens"),
    "complete": ("request", "tenant", "tokens", "ttft_s", "tpot_s"),
    "health": ("state", "prev", "pressure"),
    "serve_step": ("step", "active", "queued", "blocks_free"),
    "serve_report": ("offered", "completed", "goodput_tps"),
}


def event_type(record: dict) -> str | None:
    """Logical event type of ``record``, or None for unrecognized shapes."""
    ev = record.get("event")
    if ev is not None:
        return str(ev)
    if "step" in record and "loss" in record:
        return "step"
    return None


def validate_record(record: dict) -> list[str]:
    """Return schema violations for ``record`` (empty list = valid).

    Unknown event types are violations -- the schema registry is closed so
    a typo'd event name fails CI rather than silently vanishing from
    reports. Records with no recognizable type are reported too.
    """
    ev = event_type(record)
    if ev is None:
        return [f"unrecognized record shape: keys={sorted(record)}"]
    required = EVENT_FIELDS.get(ev)
    if required is None:
        return [f"unknown event type {ev!r}"]
    missing = [k for k in required if k not in record]
    return [f"event {ev!r} missing field {k!r}" for k in missing]


class StdoutSink:
    """Verbatim ``json.dumps`` to stdout, skipping :data:`QUIET_EVENTS`.

    Emits exactly what ``print(json.dumps(rec), flush=True)`` used to, so
    downstream line parsers are untouched.
    """

    def __init__(self, exclude: tuple[str, ...] = QUIET_EVENTS, stream=None):
        self.exclude = tuple(exclude)
        self.stream = stream

    def emit(self, record: dict) -> None:
        if event_type(record) in self.exclude:
            return
        stream = self.stream if self.stream is not None else sys.stdout
        print(json.dumps(record), file=stream, flush=True)

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-mode JSONL with per-record flush + fsync.

    Opened with ``O_APPEND`` semantics so a resumed run extends the same
    file: the full incident timeline (run → kill → resume → run) lives in
    one trail. A timestamp (``"ts"``, epoch seconds) is added to each
    record on the way out; the in-process record dict is not mutated.
    """

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f: io.TextIOWrapper | None = open(self.path, "a", encoding="utf-8")

    def emit(self, record: dict) -> None:
        if self._f is None:
            return
        line = json.dumps({**record, "ts": round(time.time(), 3)})
        self._f.write(line + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class MemorySink:
    """Record list for tests; ``records`` is the backing list itself."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class Bus:
    """Fan-out of telemetry records to sinks, plus monotonic counters.

    Sinks are invoked in registration order; register durable sinks first
    so anything a later (e.g. stdout) sink exposes is already persisted.
    """

    def __init__(self, sinks: list | None = None):
        self.sinks = list(sinks or [])
        self.counters: dict[str, int] = {}

    def emit(self, record: dict) -> None:
        for sink in self.sinks:
            sink.emit(record)

    def event(self, name: str, /, **fields: Any) -> dict:
        rec = {"event": name, **fields}
        self.emit(rec)
        return rec

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


class _NullBus(Bus):
    """Default bus: swallows everything, counters still work."""

    def emit(self, record: dict) -> None:  # noqa: ARG002
        pass


_BUS: Bus = _NullBus()


def get_bus() -> Bus:
    return _BUS


def set_bus(bus: Bus | None) -> Bus:
    """Install ``bus`` as the process-wide bus; None resets to a null bus.

    Returns the previously installed bus so callers can restore it.
    """
    global _BUS
    prev = _BUS
    _BUS = bus if bus is not None else _NullBus()
    return prev


def read_jsonl(path: str, on_torn: Callable[[int, str], None] | None = None) -> list[dict]:
    """Parse a JSONL trail, tolerating one torn final line (SIGKILL mid-write).

    A malformed line anywhere but the end raises ValueError -- that is
    corruption, not a crash artifact. A malformed *final* line is dropped
    (and reported via ``on_torn(lineno, line)`` if given).
    """
    records: list[dict] = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                if on_torn is not None:
                    on_torn(i + 1, line)
                break
            raise ValueError(f"{path}:{i + 1}: malformed JSONL mid-file: {line[:80]!r}")
    return records
