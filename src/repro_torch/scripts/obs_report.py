"""Aggregate a run's telemetry JSONL into a human-readable report.

Counterpart of the reference's ``scripts/obs_report.py`` over the port's
own bus and spans, without its comm-drift section (the port has no
distributed plan to drift from yet) and its serving section (no serving
path yet). Input is the append-streamed trail
``repro_torch.launch.train --log-file`` writes (one JSON record per line;
schema in ``repro_torch.obs.bus.EVENT_FIELDS``). Because the file is
append-mode and survives restarts, one trail can span several launches --
kills and resumes show up in the incident timeline.

  PYTHONPATH=src python -m repro_torch.scripts.obs_report run.jsonl --strict

Sections:

* **step times** -- p50/p95/p99 wall-time percentiles from ``step`` span
  records, overall and per MuonBP phase (block vs full), plus span
  breakdowns for checkpoint.save / verify / restore / resume.
* **counters** -- merged from ``run_end`` records (guard skips,
  escalations, checkpoint saves/fallbacks, NS launch counts).
* **incident timeline** -- chronological run_start / unhealthy steps /
  escalations / checkpoints / kills (inferred: a run_start or resume with
  no preceding run_end) / resumes / aborts.

Exit status: 0 clean; 1 when --strict finds schema violations, when
--require-phase-spans finds a phase with no spans, or when
--require-event TYPE finds no event of TYPE.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.bus import event_type, read_jsonl, validate_record
from repro_torch.obs.spans import percentiles


def step_time_section(records: list[dict]) -> list[str]:
    spans = [r for r in records if event_type(r) == "span"]
    lines = ["== step times =="]
    steps = [r for r in spans if r.get("name") == "step"]
    if not steps:
        lines.append("no step spans recorded")
        return lines
    by_phase: dict[str, list[float]] = {}
    for r in steps:
        by_phase.setdefault(str(r.get("phase", "?")), []).append(r["dur_s"])
    groups = [("all", [r["dur_s"] for r in steps])]
    groups += sorted(by_phase.items())
    for name, vals in groups:
        p = percentiles(vals)
        lines.append(
            f"{name:>6}: n={len(vals):<4d} p50={p['p50'] * 1e3:9.2f}ms "
            f"p95={p['p95'] * 1e3:9.2f}ms p99={p['p99'] * 1e3:9.2f}ms"
        )
    for name in sorted({r.get("name") for r in spans} - {"step"}):
        vals = [r["dur_s"] for r in spans if r.get("name") == name]
        p = percentiles(vals)
        lines.append(
            f"{name}: n={len(vals)} p50={p['p50'] * 1e3:.2f}ms "
            f"p95={p['p95'] * 1e3:.2f}ms"
        )
    return lines


def counters_section(records: list[dict]) -> list[str]:
    merged: dict[str, int] = {}
    for r in records:
        if event_type(r) == "run_end":
            for k, v in (r.get("counters") or {}).items():
                merged[k] = merged.get(k, 0) + int(v)
    lines = ["== counters =="]
    if not merged:
        lines.append("none recorded (run_end missing -- killed run?)")
        return lines
    for k in sorted(merged):
        lines.append(f"{k}: {merged[k]}")
    return lines


def timeline_section(records: list[dict]) -> list[str]:
    lines = ["== incident timeline =="]
    open_run = False  # saw run_start without run_end yet
    last_step = None

    def ts(r: dict) -> str:
        return f"[t={r['ts']:.3f}] " if "ts" in r else ""

    for r in records:
        ev = event_type(r)
        if ev == "run_start":
            if open_run:
                lines.append(f"{ts(r)}KILL inferred: previous launch ended "
                             f"without run_end (last step {last_step})")
            lines.append(f"{ts(r)}run_start argv={' '.join(r.get('argv', []))}")
            open_run = True
        elif ev == "run_end":
            lines.append(f"{ts(r)}run_end status={r.get('status')} "
                         f"steps={r.get('steps')} wall={r.get('wall_s')}s")
            open_run = False
        elif ev == "step":
            last_step = r.get("step")
            if r.get("healthy") == 0:
                lines.append(f"{ts(r)}step {r['step']}: UNHEALTHY "
                             f"loss={r.get('loss')} -- update skipped "
                             f"(cumulative skips {r.get('skipped')})")
        elif ev == "escalation":
            lines.append(f"{ts(r)}step {r.get('step')}: escalation -> "
                         f"{r.get('action')}")
        elif ev == "checkpoint":
            lines.append(f"{ts(r)}step {r.get('step')}: checkpoint "
                         f"{r.get('path')}")
        elif ev == "skip_snapshot":
            lines.append(f"{ts(r)}snapshot fallback: skipped "
                         f"{r.get('path')} ({r.get('why')})")
        elif ev == "resume":
            if r.get("snapshot"):
                lines.append(f"{ts(r)}RESUME at step {r.get('step')} from "
                             f"{r.get('snapshot')}")
            else:
                lines.append(f"{ts(r)}resume requested, no snapshot -- "
                             f"fresh start")
        elif ev == "abort":
            lines.append(f"{ts(r)}step {r.get('step')}: ABORT after "
                         f"{r.get('consecutive_skips')} consecutive skips")
    if open_run:
        lines.append(f"KILL inferred: trail ends without run_end "
                     f"(last step {last_step})")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("log_file", help="telemetry JSONL from train --log-file")
    ap.add_argument("--strict", action="store_true",
                    help="fail on schema violations (unknown event types, "
                         "missing required fields) or mid-file corruption")
    ap.add_argument("--require-phase-spans", action="store_true",
                    help="fail unless every phase seen in step records also "
                         "has >=1 step span")
    ap.add_argument("--require-event", action="append", default=[],
                    metavar="TYPE",
                    help="fail unless >=1 event of TYPE is present "
                         "(repeatable; e.g. --require-event shed asserts an "
                         "overload run actually shed)")
    args = ap.parse_args()

    torn: list[int] = []
    try:
        records = read_jsonl(args.log_file,
                             on_torn=lambda n, _line: torn.append(n))
    except ValueError as e:
        print(f"obs_report: FAIL -- {e}", file=sys.stderr)
        return 1
    print(f"{args.log_file}: {len(records)} records"
          + (f" (+1 torn final line -- killed mid-write)" if torn else ""))

    failures: list[str] = []
    violations: list[str] = []
    for i, r in enumerate(records):
        for v in validate_record(r):
            violations.append(f"record {i}: {v}")
    if violations:
        for v in violations[:10]:
            print(f"schema violation: {v}", file=sys.stderr)
        if len(violations) > 10:
            print(f"... {len(violations) - 10} more", file=sys.stderr)
        if args.strict:
            failures.append(f"{len(violations)} schema violation(s)")

    for line in step_time_section(records):
        print(line)
    for line in counters_section(records):
        print(line)
    for line in timeline_section(records):
        print(line)

    if args.require_phase_spans:
        phases = {str(r.get("phase")) for r in records
                  if event_type(r) == "step"}
        span_phases = {str(r.get("phase")) for r in records
                       if event_type(r) == "span" and r.get("name") == "step"}
        missing = phases - span_phases
        if missing:
            failures.append(f"phases with step records but no spans: "
                            f"{sorted(missing)}")
        if not span_phases:
            failures.append("no step spans at all")
    if args.require_event:
        present = {event_type(r) for r in records}
        for want in args.require_event:
            if want not in present:
                failures.append(f"required event type {want!r} absent")

    if failures:
        for f in failures:
            print(f"obs_report: FAIL -- {f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
