"""Chaos harness: train under a deterministic fault plan and prove recovery.

Counterpart of the reference's ``scripts/chaos_run.py`` for the port.
Launches ``repro_torch.launch.train`` as a subprocess with
``--fault-plan``, watches it get SIGKILLed (by the plan's
``kill_in_save@K`` / ``kill_mid_save@K`` faults, fired from inside
``checkpoint.save``), relaunches with ``--resume`` until the run completes,
then asserts the whole trajectory is sane:

* every relaunch actually resumed from a snapshot (not step 0), and from
  the last one the killed launches completed (the step after the last
  ``checkpoint`` event they printed),
* the logged steps cover the run contiguously across launches,
* the final step is ``steps - 1`` and its loss is finite,
* with ``--guard``, the cumulative skip counter matches the number of
  injected grad faults (each NaN/Inf/spike was skipped, none leaked),
* telemetry is crash-durable: the JSONL trail (``--log-file``, injected
  automatically next to the checkpoint dir when not given) stays parseable
  through every SIGKILL -- at most one torn final line -- and every record
  the parser saw on stdout is present on disk, including those from
  launches that died. This is checked after EACH killed launch, not just
  at the end.

Exit 0 only when every assertion holds -- this is the CI preemption smoke.

Example (on the CPU; drop ``--device cpu`` on a machine with a card):
  PYTHONPATH=src python -m repro_torch.scripts.chaos_run \
      --plan 'nan_grads@3,kill_in_save@5' --max-restarts 3 -- \
      --arch muonbp-960m --reduced --steps 10 --batch 2 --seq 32 \
      --period 3 --guard --checkpoint-every 2 --checkpoint-dir chaos_ckpt \
      --log-every 1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from collections import Counter

from repro_torch.obs.bus import read_jsonl
from repro_torch.training.faults import GRAD_KINDS, FaultPlan


def telemetry_failures(log_file: str, stdout_recs: list[dict],
                       label: str) -> list[str]:
    """Durability check: the JSONL trail parses (<=1 torn final line) and
    contains every record observed on stdout so far (the JSONL sink writes
    and fsyncs before the stdout sink prints)."""
    torn: list[str] = []
    try:
        disk = read_jsonl(log_file,
                          on_torn=lambda n, _line: torn.append(f"line {n}"))
    except FileNotFoundError:
        return [f"{label}: telemetry file {log_file} missing"]
    except ValueError as e:
        return [f"{label}: telemetry corrupt mid-file: {e}"]
    def key(r: dict) -> str:
        return json.dumps({k: v for k, v in r.items() if k != "ts"},
                          sort_keys=True)

    on_disk = Counter(key(r) for r in disk)
    missing = []
    for r in stdout_recs:
        k = key(r)
        if on_disk[k] > 0:
            on_disk[k] -= 1
        else:
            missing.append(k)
    out = []
    if missing:
        out.append(f"{label}: {len(missing)} stdout record(s) absent from "
                   f"{log_file} (first: {missing[0][:120]})")
    if torn:
        # One torn final line is the expected SIGKILL artifact; read_jsonl
        # already rejects tears anywhere else.
        print(f"chaos_run: note -- torn final JSONL line after kill "
              f"({torn[0]}), as expected", flush=True)
    return out


def run_once(cmd: list[str]) -> tuple[int, list[dict]]:
    """Run one launch; returns (returncode, parsed json log records)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    recs = []
    for line in proc.stdout:
        line = line.rstrip()
        print(line, flush=True)
        if line.startswith("{"):
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    proc.wait()
    return proc.returncode, recs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", default=None,
                    help="fault spec for the FIRST launch (kill faults are "
                         "stripped on restarts so replayed saves don't "
                         "crash-loop; grad faults replay deterministically)")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="arguments after '--' go to repro_torch.launch.train")
    args = ap.parse_args()
    train_args = [a for a in args.train_args if a != "--"]
    if "--steps" not in train_args:
        print("chaos_run: pass --steps in the train args", file=sys.stderr)
        return 2
    steps = int(train_args[train_args.index("--steps") + 1])
    guarded = "--guard" in train_args

    plan = FaultPlan.parse(args.plan) if args.plan else None
    # Telemetry durability is part of the drill: ensure a JSONL trail
    # exists (next to the checkpoint dir unless the caller chose one) so
    # the post-kill assertions below have a file to check.
    if "--log-file" in train_args:
        log_file = train_args[train_args.index("--log-file") + 1]
    else:
        if "--checkpoint-dir" in train_args:
            ckpt_dir = train_args[train_args.index("--checkpoint-dir") + 1]
        else:
            ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_chaos")
        log_file = ckpt_dir + "/telemetry.jsonl"
        train_args = train_args + ["--log-file", log_file]
    base = [sys.executable, "-m", "repro_torch.launch.train"] + train_args

    failures: list[str] = []
    launches: list[list[dict]] = []
    restarts = 0
    cmd = base + (["--fault-plan", plan.spec()] if plan else [])
    while True:
        rc, recs = run_once(cmd)
        launches.append(recs)
        # Crash-durability: check after EVERY launch -- most importantly the
        # killed ones, where the buffered-log design lost everything.
        stdout_recs = [r for rs in launches for r in rs]
        failures += telemetry_failures(log_file, stdout_recs,
                                       f"launch {len(launches) - 1} (rc={rc})")
        if rc == 0:
            break
        kind = "killed" if rc < 0 or rc == 137 else f"exit {rc}"
        restarts += 1
        if restarts > args.max_restarts:
            print(f"chaos_run: FAIL -- {kind}, restart budget exhausted "
                  f"({args.max_restarts})", file=sys.stderr)
            return 1
        print(f"chaos_run: launch died ({kind}); restart {restarts} with "
              f"--resume", flush=True)
        replay = plan.without_kills() if plan else None
        cmd = base + ["--resume"] + (
            ["--fault-plan", replay.spec()] if replay and replay.faults else [])

    # ---- trajectory assertions ------------------------------------------
    step_recs = [r for recs in launches for r in recs if "loss" in r]
    if not step_recs or step_recs[-1]["step"] != steps - 1:
        failures.append(f"final logged step is not {steps - 1}: "
                        f"{step_recs[-1]['step'] if step_recs else None}")
    elif not math.isfinite(step_recs[-1]["loss"]):
        failures.append(f"final loss not finite: {step_recs[-1]['loss']}")
    for i, recs in enumerate(launches[1:], start=1):
        resume = next((r for r in recs if r.get("event") == "resume"), None)
        saved = [r["step"] for rs in launches[:i] for r in rs
                 if r.get("event") == "checkpoint"]
        if resume is None:
            failures.append(f"launch {i} logged no resume event")
        elif resume["step"] == 0 or resume.get("snapshot") is None:
            failures.append(f"launch {i} restarted from scratch instead of "
                            f"resuming: {resume}")
        elif saved and resume["step"] != saved[-1] + 1:
            failures.append(f"launch {i} resumed at step {resume['step']}, not after "
                            f"the last completed snapshot (step {saved[-1]})")
    # Contiguity: each launch must continue at or before the previous
    # launch's next step (replay from an older snapshot is fine, a gap is
    # data loss).
    prev_last = None
    for i, recs in enumerate(launches):
        launch_steps = [r["step"] for r in recs if "loss" in r]
        if not launch_steps:
            continue
        if prev_last is not None and launch_steps[0] > prev_last + 1:
            failures.append(f"launch {i} starts at step {launch_steps[0]}, "
                            f"gap after {prev_last}")
        prev_last = launch_steps[-1]
    if plan and guarded:
        # Count only in-graph faults: kill/serving kinds never reach the
        # guard, so excluding kinds by name here would silently miscount
        # as the fault grammar grows.
        grad_faults = [f for f in plan.faults if f.kind in GRAD_KINDS]
        want = len(grad_faults)
        got = max((r.get("skipped", 0) for recs in launches for r in recs
                   if "loss" in r), default=0)
        if got < want:
            failures.append(f"guard skipped {got} steps, plan injected {want} "
                            f"grad faults -- a fault leaked into the update")

    if failures:
        for f in failures:
            print(f"chaos_run: FAIL -- {f}", file=sys.stderr)
        return 1
    print(f"chaos_run: OK -- {steps} steps, {restarts} restart(s), "
          f"recovery verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
