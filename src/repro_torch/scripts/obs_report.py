"""Aggregate a run's telemetry JSONL into a human-readable report.

Counterpart of the reference's ``scripts/obs_report.py`` over the port's
own bus and spans. Input is the append-streamed trail
``repro_torch.launch.train --log-file`` or
``repro_torch.scripts.serve_sim --log-file`` writes (one JSON record per line;
schema in ``repro_torch.obs.bus.EVENT_FIELDS``). Because the file is
append-mode and survives restarts, one trail can span several launches --
kills and resumes show up in the incident timeline.

  PYTHONPATH=src python -m repro_torch.scripts.obs_report run.jsonl --strict

Sections:

* **step times** -- p50/p95/p99 wall-time percentiles from ``step`` span
  records, overall and per MuonBP phase (block vs full; per step residue
  too on ``--full-schedule staggered`` runs), plus span breakdowns for
  checkpoint.save / verify / restore / resume.
* **comm drift** -- the last ``comm_rates`` summary (modeled vs achieved
  bytes/s per link class; per residue on a staggered run) and every
  ``drift`` event (``repro_torch.obs.drift``). The modeled rates are the
  plan's planning constants, not a measurement.
* **serving** -- present only when the trail carries serving traffic
  (``repro_torch.scripts.serve_sim`` / ``repro_torch.serving.engine``):
  outcome counts by type and reason, virtual-clock TTFT / per-token
  percentiles from ``complete`` events, wall-clock decode-dispatch
  percentiles from ``serve_decode`` spans, and the final goodput-vs-offered
  summary.
* **counters** -- merged from ``run_end`` records (guard skips,
  escalations, checkpoint saves/fallbacks, NS launch counts).
* **incident timeline** -- chronological run_start / unhealthy steps /
  escalations / checkpoints / kills (inferred: a run_start or resume with
  no preceding run_end) / resumes / aborts.

Exit status: 0 clean; 1 when --strict finds schema violations, when
--require-phase-spans finds a phase with no spans, when
--require-zero-drift finds drift events, or when --require-event TYPE
finds no event of TYPE.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.bus import event_type, read_jsonl, validate_record
from repro_torch.obs.spans import percentiles


def fmt_bytes_per_s(v: float) -> str:
    if v >= 1e9:
        return f"{v / 1e9:.2f} GB/s"
    if v >= 1e6:
        return f"{v / 1e6:.2f} MB/s"
    return f"{v:.0f} B/s"


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
    # Staggered, the phase is the step residue, and the question is whether
    # the step time is flat across residues: percentiles per residue too.
    if any(str(r.get("phase", "")).startswith("stagger:") for r in steps):
        by_residue: dict[int, list[float]] = {}
        for r in steps:
            if "residue" in r:
                by_residue.setdefault(int(r["residue"]), []).append(r["dur_s"])
        groups += [(f"r={res}", vals) for res, vals in sorted(by_residue.items())]
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


def drift_section(records: list[dict]) -> tuple[list[str], int]:
    lines = ["== comm drift =="]
    drifts = [r for r in records if event_type(r) == "drift"]
    rates = [r for r in records if event_type(r) == "comm_rates"]
    if rates:
        last = rates[-1]
        modeled = last.get("modeled_bytes_per_s", {})
        achieved = last.get("achieved_bytes_per_s", {})
        for link in sorted(modeled):
            got = achieved.get(link)
            lines.append(
                f"{link}: modeled {fmt_bytes_per_s(modeled[link])}"
                + (f", achieved {fmt_bytes_per_s(got)}" if got is not None
                   else ", achieved n/a (no measurable full-step comm)")
            )
        if last.get("measured_extra_s") is not None:
            lines.append(
                f"full-step extra wall: measured "
                f"{last['measured_extra_s'] * 1e3:.2f}ms vs modeled "
                f"{last['modeled_extra_s'] * 1e3:.2f}ms "
                f"(block n={last.get('block_n')}, full n={last.get('full_n')})"
            )
        if last.get("modeled_s_by_residue") is not None:
            # The staggered summary (ResidueDriftMonitor): each residue's
            # modeled comm time and measured wall EMA.
            emas = last.get("ema_s_by_residue") or {}
            base = last.get("baseline_residue")
            for res, modeled_s in enumerate(last["modeled_s_by_residue"]):
                ema = emas.get(str(res))
                lines.append(
                    f"residue {res}{' (baseline)' if res == base else ''}: "
                    f"modeled comm {modeled_s * 1e3:.2f}ms"
                    + (f", wall EMA {ema * 1e3:.2f}ms" if ema is not None
                       else ", no steps observed")
                )
    else:
        lines.append("no comm_rates summary recorded")
    lines.append(f"drift events: {len(drifts)}")
    for r in drifts:
        where = (f" [residue {r['residue']}]" if "residue" in r else "")
        lines.append(
            f"  step {r.get('step')}{where}: measured/modeled ratio "
            f"{r.get('ratio')} "
            f"({r.get('measured_extra_s')}s vs {r.get('modeled_extra_s')}s)"
        )
    return lines, len(drifts)


def serving_section(records: list[dict]) -> list[str]:
    """Serving-engine rollup from admit/reject/shed/cancel/complete events.

    Only rendered when the trail contains serving traffic (a training-only
    trail keeps its old report byte-for-byte)."""
    kinds = ("admit", "reject", "shed", "cancel", "complete", "serve_report")
    if not any(event_type(r) in kinds for r in records):
        return []
    lines = ["== serving =="]
    by_outcome: dict[str, int] = {}
    for r in records:
        ev = event_type(r)
        if ev in ("reject", "shed", "cancel"):
            key = f"{ev}:{r.get('reason')}"
        elif ev in ("admit", "complete"):
            key = ev
        else:
            continue
        by_outcome[key] = by_outcome.get(key, 0) + 1
    for k in sorted(by_outcome):
        lines.append(f"{k}: {by_outcome[k]}")
    completes = [r for r in records if event_type(r) == "complete"]
    ttft = percentiles([r["ttft_s"] for r in completes if "ttft_s" in r])
    tpot = percentiles([r["tpot_s"] for r in completes
                        if r.get("tpot_s") is not None and r["tpot_s"] > 0])
    if ttft:
        lines.append(f"ttft: p50={ttft['p50'] * 1e3:.1f}ms "
                     f"p95={ttft['p95'] * 1e3:.1f}ms "
                     f"p99={ttft['p99'] * 1e3:.1f}ms (virtual)")
    if tpot:
        lines.append(f"per-token: p50={tpot['p50'] * 1e3:.1f}ms "
                     f"p95={tpot['p95'] * 1e3:.1f}ms "
                     f"p99={tpot['p99'] * 1e3:.1f}ms (virtual)")
    decode = percentiles([r["dur_s"] for r in records
                          if event_type(r) == "span"
                          and r.get("name") == "serve_decode"])
    if decode:
        lines.append(f"decode dispatch (wall): p50={decode['p50'] * 1e3:.1f}ms "
                     f"p95={decode['p95'] * 1e3:.1f}ms")
    for r in records:
        if event_type(r) == "serve_report":
            lines.append(
                f"offered {r.get('offered')} req / "
                f"{r.get('offered_tokens')} tok; completed "
                f"{r.get('completed')} req / {r.get('completed_tokens')} tok; "
                f"goodput {r.get('goodput_tps')} tok/s vs offered "
                f"{r.get('offered_tps')} tok/s; shed {r.get('shed')}; "
                f"timeouts {r.get('timeouts')}")
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
        elif ev == "drift":
            lines.append(f"{ts(r)}step {r.get('step')}: comm drift "
                         f"ratio={r.get('ratio')}")
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
    ap.add_argument("--require-zero-drift", action="store_true",
                    help="fail if any drift event is present")
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
    drift_lines, n_drift = drift_section(records)
    for line in drift_lines:
        print(line)
    for line in serving_section(records):
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
    if args.require_zero_drift and n_drift:
        failures.append(f"{n_drift} drift event(s) present")
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
