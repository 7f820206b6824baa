"""The port's plan-vs-runtime drift monitor against the reference's.

The same recorded wall series go through ``repro.obs.drift`` and
``repro_torch.obs.drift``: every ``drift`` event a monitor emits on its
bus and its ``report()`` record must be equal, field for field. The cases
are ``tests/test_obs.py``'s (silent when the walls are exact, fires on a
mismatch either way, silent at zero bytes, warmup, cooldown) for the
synchronous :class:`DriftMonitor`, and the same for the staggered
:class:`ResidueDriftMonitor` (per residue against the residue with the
smallest bill). The rates are synthetic (100 MB/s) or the plan's planning
constants; no number here is a measurement. Last, the port's
``obs_report`` prints the reference script's step and drift sections for
one staggered trail.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.obs import bus as j_bus
from repro.obs import drift as j_drift
from repro_torch.obs import Bus, DriftConfig, DriftMonitor, MemorySink, ResidueDriftMonitor
from repro_torch.obs import drift

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 100e6                      # synthetic link, as tests/test_obs.py
BYTES = {"ici": 50 * 2 ** 20}     # -> modeled extra 0.524 s
RESIDUE_BYTES = ({"ici": 0}, {"ici": 50 * 2 ** 20}, {"ici": 20 * 2 ** 20})


def _sync_walls(extra, n=6, base=0.10, jitter=0.0, seed=0):
    rng = np.random.default_rng(seed)
    walls = []
    for i in range(n):
        walls.append((2 * i, "block", base + jitter * float(rng.random())))
        walls.append((2 * i + 1, "full", base + extra + jitter * float(rng.random())))
    return walls


def _residue_walls(extras, n=4, base=0.10, jitter=0.0, seed=0):
    rng = np.random.default_rng(seed)
    period = len(extras)
    return [(t, f"stagger:{t % period}", base + extras[t % period] + jitter * float(rng.random()))
            for t in range(n * period)]


def _both(make_port, make_ref, walls):
    """Feed ``walls`` to the port's monitor and the reference's; returns
    (port records, reference records, port monitor): each observe's return,
    the bus's drift events and the report."""
    out = []
    for make, bus_cls, sink_cls in ((make_port, Bus, MemorySink),
                                    (make_ref, j_bus.Bus, j_bus.MemorySink)):
        sink = sink_cls()
        mon = make(bus_cls([sink]))
        fired = [mon.observe(step, phase, wall) for step, phase, wall in walls]
        report = mon.report()
        strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]
        out.append((fired, strip(sink.records), report, mon))
    (p_fired, p_recs, p_rep, p_mon), (r_fired, r_recs, r_rep, _) = out
    assert p_fired == r_fired
    assert p_recs == r_recs
    assert p_rep == r_rep
    return p_recs, p_mon


def _sync(extra_of_modeled, *, cfg=None, bytes_by_link=BYTES, rates=None, **walls_kw):
    rates = rates or {"ici": RATE}
    modeled = sum(b / rates[k] for k, b in bytes_by_link.items() if b)
    make = lambda cfg_cls, mon_cls: (lambda bus: mon_cls(
        comm_bytes_by_link=bytes_by_link, rates=rates,
        cfg=cfg_cls(**(cfg or {})), bus=bus))
    return _both(make(DriftConfig, DriftMonitor),
                 make(j_drift.DriftConfig, j_drift.DriftMonitor),
                 _sync_walls(extra_of_modeled * modeled if modeled else 0.5, **walls_kw))


def _residue(scales, *, cfg=None, bytes_by_residue=RESIDUE_BYTES, **walls_kw):
    rates = {"ici": RATE}
    modeled = [sum(b / rates[k] for k, b in by.items() if b) for by in bytes_by_residue]
    extras = [s * m for s, m in zip(scales, modeled)]
    make = lambda cfg_cls, mon_cls: (lambda bus: mon_cls(
        comm_bytes_by_residue=bytes_by_residue, rates=rates, cfg=cfg_cls(**(cfg or {})),
        bus=bus))
    return _both(make(DriftConfig, ResidueDriftMonitor),
                 make(j_drift.DriftConfig, j_drift.ResidueDriftMonitor),
                 _residue_walls(extras, **walls_kw))


def _drifts(recs):
    return [r for r in recs if r.get("event") == "drift"]


# ---------------------------------------------------------------------------
# DriftMonitor (synchronous)
# ---------------------------------------------------------------------------

def test_sync_silent_on_plan_exact_walls():
    recs, mon = _sync(1.0)
    assert not _drifts(recs) and mon.drift_events == 0
    assert mon.report()["achieved_bytes_per_s"]["ici"] == pytest.approx(RATE, rel=0.01)


@pytest.mark.parametrize("scale", [10.0, 0.1])
def test_sync_fires_on_a_mismatch_either_way(scale):
    recs, mon = _sync(scale, n=12)
    drifts = _drifts(recs)
    assert drifts and (drifts[0]["ratio"] > 2.0 if scale > 1 else drifts[0]["ratio"] < 0.5)
    # Cooldown: a persistent drift does not fire every full step.
    assert 1 <= mon.drift_events < mon.full_n


def test_sync_silent_at_zero_bytes():
    recs, mon = _sync(1.0, bytes_by_link={"ici": 0, "dcn": 0},
                      rates={"ici": RATE, "dcn": RATE})
    assert not _drifts(recs) and mon.report()["achieved_bytes_per_s"] == {}


def test_sync_respects_warmup():
    recs, mon = _sync(10.0, n=1, cfg={"warmup": 3})
    assert not _drifts(recs) and mon.drift_events == 0


def test_sync_cooldown_and_jitter_on_the_plan_rates():
    """Noisy walls at the plan's planning rates (two links), a short
    cooldown: the same events at the same steps."""
    from repro_torch.distributed.plan import MODELED_LINK_BYTES_PER_S

    recs, mon = _sync(6.0, n=20, jitter=0.05, cfg={"cooldown": 1, "ema_beta": 0.5},
                      bytes_by_link={"ici": 3 * 2 ** 30, "dcn": 2 ** 28},
                      rates=dict(MODELED_LINK_BYTES_PER_S))
    assert len(_drifts(recs)) >= 2 and set(mon.report()["achieved_bytes_per_s"]) == {
        "ici", "dcn"}


# ---------------------------------------------------------------------------
# ResidueDriftMonitor (staggered)
# ---------------------------------------------------------------------------

def test_residue_silent_on_plan_exact_walls():
    recs, mon = _residue([1.0, 1.0, 1.0])
    assert not _drifts(recs) and mon.drift_events == 0
    rep = mon.report()
    assert rep["baseline_residue"] == 0
    assert rep["achieved_bytes_per_s"]["ici"] == pytest.approx(RATE, rel=0.01)


@pytest.mark.parametrize("scale", [10.0, 0.1])
def test_residue_fires_on_a_mismatch_either_way(scale):
    recs, mon = _residue([1.0, scale, scale], n=8)
    drifts = _drifts(recs)
    assert drifts and all(d["residue"] in (1, 2) and d["baseline_residue"] == 0
                          for d in drifts)
    assert 1 <= mon.drift_events < sum(mon.counts.values())


def test_residue_silent_at_zero_bytes():
    recs, mon = _residue([1.0, 1.0, 1.0], bytes_by_residue=({"ici": 0},) * 3)
    assert not _drifts(recs) and mon.report()["achieved_bytes_per_s"] == {}


def test_residue_respects_warmup_and_ignores_other_phases():
    recs, mon = _residue([1.0, 10.0, 10.0], n=1, cfg={"warmup": 2})
    assert not _drifts(recs)
    for phase in ("block", "full", "stagger:3", "stagger:x"):
        assert mon.observe(0, phase, 9.0) is None


def test_residue_cooldown_with_jitter():
    recs, _ = _residue([1.0, 5.0, 0.2], n=10, jitter=0.05,
                       cfg={"cooldown": 2, "ema_beta": 0.5})
    assert len(_drifts(recs)) >= 2


def test_exposed_by_link_matches_reference():
    class FakeSchedule:
        exposed_bytes = 1000
        exposed_dcn_bytes = 300

    assert drift.exposed_by_link(FakeSchedule()) == j_drift.exposed_by_link(FakeSchedule())
    assert drift.exposed_by_link(FakeSchedule()) == {"ici": 700, "dcn": 300}


# ---------------------------------------------------------------------------
# obs_report's drift section against the reference script
# ---------------------------------------------------------------------------

def test_obs_report_drift_section_matches_reference(tmp_path):
    records = [{"event": "run_start", "argv": [], "ts": 1.0}]
    walls = _residue_walls([0.0, 0.3, 0.1], n=3, jitter=0.02)
    for step, phase, wall in walls:
        records.append({"event": "span", "name": "step", "dur_s": wall, "step": step,
                        "phase": phase, "residue": int(phase.split(":")[1]), "due": 2,
                        "ts": 2.0 + step})
    sink = MemorySink()
    mon = ResidueDriftMonitor(comm_bytes_by_residue=RESIDUE_BYTES, rates={"ici": RATE},
                              cfg=DriftConfig(warmup=1, cooldown=0), bus=Bus([sink]))
    for step, phase, wall in walls:
        mon.observe(step, phase, wall)
    mon.report()
    records += sink.records
    records.append({"event": "run_end", "steps": len(walls), "wall_s": 1.0, "status": "ok",
                    "counters": {}, "ts": 99.0})
    trail = tmp_path / "trail.jsonl"
    trail.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert _drifts(records)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def report(cmd):
        proc = subprocess.run(cmd + [str(trail), "--require-zero-drift"], capture_output=True,
                              text=True, cwd=ROOT, env=env, timeout=120)
        assert proc.returncode == 1 and "drift event(s) present" in proc.stderr
        lines = proc.stdout.splitlines()
        start = lines.index("== step times ==")
        end = next(i for i, line in enumerate(lines) if line == "== counters ==")
        return lines[start:end]

    port = report([sys.executable, "-m", "repro_torch.scripts.obs_report"])
    ref = report([sys.executable, os.path.join("scripts", "obs_report.py")])
    assert port == ref
    assert "== comm drift ==" in port and any(line.startswith("   r=2:") for line in port)
    assert any("(baseline)" in line for line in port)
