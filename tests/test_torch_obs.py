"""The port's telemetry bus and spans, against the reference's.

The bus and span cases of ``tests/test_obs.py`` on the port's copy, plus its
parity with the reference: the same stdout lines, the same schema verdicts
and the same percentiles for the same records. Instrumentation must not
change a step: optimizer steps run inside ``span`` (no sync) with counters
and the NS dispatch hook are ``torch.equal`` to uninstrumented ones, and the
launcher's counters come out in ``run_end``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.obs import bus as j_bus
from repro.obs import spans as j_spans
from repro_torch import tree as tree_lib
from repro_torch.core import adamw, combine, label_tree, muon
from repro_torch.core.combine import apply_updates
from repro_torch.kernels import dispatch
from repro_torch.launch import train
from repro_torch.obs import (
    QUIET_EVENTS,
    Bus,
    JsonlSink,
    MemorySink,
    StdoutSink,
    event_type,
    get_bus,
    set_bus,
    span,
    validate_record,
)
from repro_torch.obs.bus import read_jsonl
from repro_torch.obs.spans import current_span, parse_profile_window, percentiles

RECORDS = [
    {"event": "checkpoint", "step": 3, "path": "/snap/step_3"},
    {"event": "span", "name": "step", "dur_s": 0.1},
    {"step": 3, "loss": 2.5, "phase": "full", "residue": 0, "due": 9, "wall_s": 1.2},
    {"event": "resume", "step": 4, "snapshot": None},
    {"event": "run_end", "steps": 2, "wall_s": 0.5, "status": "ok", "counters": {"a": 1}},
    {"event": "escalation", "step": 1},
    {"event": "not_a_thing"},
    {"foo": 1},
]


# ---------------------------------------------------------------------------
# Bus and sinks
# ---------------------------------------------------------------------------

def test_jsonl_sink_appends_and_fsyncs_each_record(tmp_path):
    path = str(tmp_path / "t.jsonl")
    sink = JsonlSink(path)
    sink.emit({"event": "checkpoint", "step": 1, "path": "/x"})
    on_disk = read_jsonl(path)
    assert len(on_disk) == 1 and on_disk[0]["step"] == 1 and "ts" in on_disk[0]
    sink.emit({"step": 2, "loss": 1.5, "phase": "block"})
    sink.close()
    assert len(read_jsonl(path)) == 2


def test_jsonl_sink_reopen_appends(tmp_path):
    path = str(tmp_path / "t.jsonl")
    for step, snap in ((0, None), (5, "/snap")):
        sink = JsonlSink(path)
        sink.emit({"event": "resume", "step": step, "snapshot": snap})
        sink.close()
    assert [r["step"] for r in read_jsonl(path)] == [0, 5]


def test_read_jsonl_tolerates_exactly_one_torn_final_line(tmp_path):
    path = str(tmp_path / "t.jsonl")
    sink = JsonlSink(path)
    for i in range(3):
        sink.emit({"step": i, "loss": 1.0, "phase": "block"})
    sink.close()
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 7)
    torn = []
    recs = read_jsonl(path, on_torn=lambda n, line: torn.append(n))
    assert [r["step"] for r in recs] == [0, 1] and len(torn) == 1
    # The reference's reader agrees on the same file.
    assert [r["step"] for r in j_bus.read_jsonl(path)] == [0, 1]


def test_read_jsonl_rejects_midfile_corruption(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        f.write('{"step": 0, "loss": 1.0}\n{"step": 1, "lo\n{"step": 2, "loss": 1.0}\n')
    with pytest.raises(ValueError, match="mid-file"):
        read_jsonl(path)


def test_stdout_wire_format_matches_the_reference(capsys):
    for rec in RECORDS:
        StdoutSink().emit(rec)
    port = capsys.readouterr().out
    for rec in RECORDS:
        j_bus.StdoutSink().emit(rec)
    assert port == capsys.readouterr().out
    lines = port.splitlines()
    assert lines[0] == json.dumps(RECORDS[0])
    assert len(lines) == len(RECORDS) - 2  # the span and run_end stay off stdout
    assert QUIET_EVENTS == j_bus.QUIET_EVENTS and "span" in QUIET_EVENTS


@pytest.mark.parametrize("rec", RECORDS)
def test_schema_verdicts_match_the_reference(rec):
    assert event_type(rec) == j_bus.event_type(rec)
    assert validate_record(rec) == j_bus.validate_record(rec)


def test_event_type_and_schema_validation():
    assert event_type({"event": "drift", "step": 1}) == "drift"
    assert event_type({"step": 1, "loss": 2.0}) == "step"
    assert event_type({"foo": 1}) is None
    assert validate_record({"event": "checkpoint", "step": 1, "path": "/x"}) == []
    assert validate_record({"event": "checkpoint", "step": 1})
    assert validate_record({"event": "not_a_thing"})


def test_bus_sink_order_and_counters(tmp_path, capsys):
    path = str(tmp_path / "t.jsonl")
    bus = Bus([JsonlSink(path), StdoutSink()])
    bus.event("resume", step=0, snapshot=None)
    bus.inc("guard.skipped_steps")
    bus.inc("guard.skipped_steps", 2)
    assert bus.counters == {"guard.skipped_steps": 3}
    stdout_lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(stdout_lines) == 1 and len(read_jsonl(path)) == 1
    assert json.loads(stdout_lines[0])["event"] == "resume"
    bus.close()


def test_null_bus_swallows_everything(capsys):
    prev = set_bus(None)
    try:
        get_bus().event("checkpoint", step=1, path="/x")
        get_bus().inc("n")
        assert capsys.readouterr().out == ""
    finally:
        set_bus(prev)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

def test_span_nesting_and_attribution():
    mem = MemorySink()
    bus = Bus([mem])
    with span(bus, "step", step=7, phase="full") as outer:
        assert current_span() is outer
        with span(bus, "checkpoint.save", step=7):
            pass
    assert current_span() is None
    inner_rec, outer_rec = mem.records
    assert inner_rec["name"] == "checkpoint.save" and inner_rec["parent"] == "step"
    assert outer_rec["name"] == "step" and "parent" not in outer_rec
    assert outer_rec["step"] == 7 and outer_rec["phase"] == "full"
    assert outer_rec["dur_s"] >= inner_rec["dur_s"] >= 0


def test_span_sync_runs_inside_clock():
    calls = []
    with span(None, "step", sync=lambda: calls.append(1)) as sp:
        pass
    assert calls == [1] and sp.dur_s is not None


@pytest.mark.parametrize("vals", [list(range(1, 101)), [], [42.0], [3.0, 1.0, 2.0, 9.5]])
def test_percentiles_match_the_reference(vals):
    assert percentiles(vals) == j_spans.percentiles(vals)


def test_percentiles_nearest_rank():
    p = percentiles(list(range(1, 101)))
    assert p["p50"] == 50 and p["p95"] == 95 and p["p99"] == 99


@pytest.mark.parametrize("spec", ["3:6", "6:3", "abc", "0:1", "-1:2"])
def test_parse_profile_window_matches_the_reference(spec):
    try:
        want = j_spans.parse_profile_window(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_profile_window(spec)
    else:
        assert parse_profile_window(spec) == want


# ---------------------------------------------------------------------------
# Instrumentation changes no step
# ---------------------------------------------------------------------------

def _run_steps(params, opt, grads, steps=4, bus=None):
    state = opt.init(params)
    for i in range(steps):
        phase = "full" if i % 2 == 0 else "block"
        if bus is not None:
            with span(bus, "step", step=i, phase=phase):
                upd, state = opt.update(grads, state, params, phase)
                params = apply_updates(params, upd)
            bus.inc("steps")
        else:
            upd, state = opt.update(grads, state, params, phase)
            params = apply_updates(params, upd)
    return params, state


def test_instrumented_steps_are_bitwise_identical():
    gen = torch.Generator().manual_seed(0)
    params = {"stack_col": torch.randn(8, 16, 32, generator=gen),
              "stack_row": torch.randn(8, 32, 16, generator=gen),
              "bias": torch.randn(32, generator=gen)}
    opt = combine({"muon": muon(1e-2, 1e-2, period=2), "adamw": adamw(1e-3)},
                  label_tree(params))
    grads = tree_lib.tree_map(lambda p: 0.1 * torch.ones_like(p), params)
    p_ref, s_ref = _run_steps(params, opt, grads)
    launches = []
    mem = MemorySink()
    dispatch.set_launch_hook(lambda dev, strategy, shape: launches.append((dev, shape)))
    try:
        p_obs, s_obs = _run_steps(params, opt, grads, bus=Bus([mem]))
    finally:
        dispatch.set_launch_hook(None)
    for a, b in zip(tree_lib.leaves(p_ref), tree_lib.leaves(p_obs)):
        assert torch.equal(a, b)
    for a, b in zip(tree_lib.leaves(s_ref.inner["muon"].momentum),
                    tree_lib.leaves(s_obs.inner["muon"].momentum)):
        assert torch.equal(a, b)
    # The hook counts every orthogonalize call: 2 stacks x 4 steps.
    assert len(launches) == 8 and all(d == "cpu" for d, _ in launches)
    assert [r["phase"] for r in mem.records] == ["full", "block", "full", "block"]


def test_launcher_counters_and_spans_reach_the_trail(tmp_path, capsys):
    log = str(tmp_path / "run.jsonl")
    argv = ["--reduced", "--steps", "3", "--batch", "1", "--seq", "8", "--period", "2",
            "--mesh-model", "2", "--device", "cpu", "--log-file", log, "--log-every", "2",
            "--obs-block", "--profile-steps", "1:2", "--profile-dir", str(tmp_path / "prof")]
    prev = get_bus()
    run = train.run(argv)
    recs = read_jsonl(log)
    assert [r for r in recs if event_type(r) not in (None, *j_bus.EVENT_FIELDS)] == []
    assert all(validate_record(r) == [] for r in recs)
    assert [event_type(r) for r in recs][0] == "run_start"
    steps = [r for r in recs if event_type(r) == "step"]
    assert [r["step"] for r in steps] == [0, 2]  # --log-every 2, and the last step
    spans = [r for r in recs if r.get("name") == "step"]
    assert [r["phase"] for r in spans] == ["full", "block", "full"]
    assert [r["dur_s"] for r in spans] == [round(r["dur_s"], 6) for r in run.records]
    end = recs[-1]
    assert end["event"] == "run_end" and end["status"] == "ok"
    assert end["counters"] == run.counters and sum(
        v for k, v in end["counters"].items() if k.startswith("ns_launch.cpu.")) > 0
    assert os.listdir(tmp_path / "prof") == ["trace_steps_1_2.json"]
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [r["step"] for r in printed] == [0, 2] and "wall_s" in printed[0]
    assert get_bus() is prev and dispatch._launch_hook is None


# ---------------------------------------------------------------------------
# The chaos drill and the report over its trail (subprocesses, on the CPU)
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name, *args, timeout=300):
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    for var in ("REPRO_KILL_IN_SAVE", "REPRO_KILL_MID_SAVE"):
        env.pop(var, None)
    return subprocess.run([sys.executable, "-m", name, *args], capture_output=True, text=True,
                          env=env, timeout=timeout, cwd=ROOT)


def test_chaos_drill_resumes_after_a_kill_and_the_report_reads_its_trail(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _module("repro_torch.scripts.chaos_run", "--plan", "nan_grads@1,kill_mid_save@3",
                  "--max-restarts", "2", "--", "--reduced", "--steps", "6", "--batch", "2",
                  "--seq", "16", "--period", "3", "--mesh-model", "2", "--guard",
                  "--checkpoint-every", "2", "--checkpoint-dir", ckpt, "--log-every", "1",
                  "--device", "cpu")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "chaos_run: OK -- 6 steps, 1 restart(s)" in out.stdout
    resumes = [json.loads(l) for l in out.stdout.splitlines()
               if l.startswith('{"event": "resume"')]
    assert [r["step"] for r in resumes] == [3]  # after the step-2 snapshot
    trail = os.path.join(ckpt, "telemetry.jsonl")
    report = _module("repro_torch.scripts.obs_report", trail, "--strict",
                     "--require-phase-spans", "--require-event", "resume")
    assert report.returncode == 0, report.stderr
    text = report.stdout
    assert "KILL inferred" in text and "RESUME at step 3" in text and "UNHEALTHY" in text
    assert "resumes: 1" in text and "checkpoint.saves: 2" in text  # the relaunch's run_end
    missing = _module("repro_torch.scripts.obs_report", trail, "--require-event", "abort")
    assert missing.returncode == 1 and "'abort' absent" in missing.stderr


def test_record_span_matches_reference():
    """A duration measured elsewhere becomes the reference's span record."""
    from repro_torch.obs import Bus, record_span

    mem, j_mem = MemorySink(), j_bus.MemorySink()
    for bus_, rec in ((Bus([mem]), record_span), (j_bus.Bus([j_mem]), j_spans.record_span)):
        rec(bus_, "train.replica_gather", 1.23456789, step=3, bytes=12)
        rec(None, "dropped", 1.0)
    assert mem.records == j_mem.records == [
        {"event": "span", "name": "train.replica_gather", "dur_s": 1.234568, "step": 3,
         "bytes": 12}]
