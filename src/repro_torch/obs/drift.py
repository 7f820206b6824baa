"""Plan-vs-runtime drift monitor (counterpart of ``repro/obs/drift.py``).

The comm plan prices every planned collective with the rates in
``distributed.plan.MODELED_LINK_BYTES_PER_S``: the reference's planning
constants, a model and not a measurement of any device. This module turns
them into a standing runtime report: it joins the plan's predicted bytes
per link class against *measured* step walls and emits a ``drift`` event
when model and run disagree beyond a threshold. On ranks that share one
card through gloo the measured walls are host copies, so a drift event
there says how far gloo is from the modeled rate, not a link's rate.

The join uses MuonBP's own structure. Block steps pay no optimizer
collective beyond the apply baseline, full steps also pay the momentum
gathers, and both run the same forward and backward. So the EMA of the
block steps' wall is a compute baseline, and::

    measured_extra = EMA(full wall) - EMA(block wall)

is the wall of exactly the comm the plan prices. The modeled counterpart
is ``sum_link bytes[link] / rate[link]`` over the caller's full-minus-block
bytes per link (the apply bytes cancel in the difference). For a pipelined
full phase, feed :func:`exposed_by_link` of its compiled
:class:`~repro_torch.core.program.PipelineSchedule` instead: only exposed
bytes cost wall time.

From one scalar the monitor cannot apportion blame across links, so the
achieved rates scale every link by ``modeled_extra / measured_extra``;
with one link class present that is the achieved rate of that link.

Where the modeled extra time is negligible (one rank, tiny configs) the
monitor stays silent by construction. :class:`ResidueDriftMonitor` does
the same per residue of the staggered schedule. Records, EMAs, warmup,
cooldown and rounding are the reference's, field for field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

from repro_torch.distributed.plan import MODELED_LINK_BYTES_PER_S
from repro_torch.obs import bus as bus_lib


def exposed_by_link(schedule) -> dict[str, int]:
    """Per-link *exposed* gather bytes of a compiled PipelineSchedule.

    The schedule tracks total and inter-pod (DCN) exposure; ICI is the
    remainder. Use this as the ``comm_bytes_by_link`` input when the full
    phase runs pipelined -- barrier schedules expose everything, so there
    the plain ``CommPlan.predicted_by_link`` delta is already exact.
    """
    dcn = int(schedule.exposed_dcn_bytes)
    return {"ici": int(schedule.exposed_bytes) - dcn, "dcn": dcn}


@dataclass
class DriftConfig:
    threshold: float = 2.0         # fire when measured/modeled leaves [1/t, t]
    ema_beta: float = 0.7          # weight on history per observation
    warmup: int = 2                # min observations of EACH phase before judging
    min_modeled_s: float = 1e-3    # below this modeled extra, stay silent
    cooldown: int = 5              # full-step observations between drift events


@dataclass
class DriftMonitor:
    """EMA-based comparison of modeled vs measured full-step comm cost.

    Feed one ``observe(step, phase, wall_s)`` per training step with the
    host-measured wall time (use ``--obs-block`` so device completion is
    included -- otherwise dispatch-only times understate both phases
    equally and the delta is noise). Emits at most one ``drift`` event per
    ``cooldown`` full-step observations; ``report()`` emits a
    ``comm_rates`` summary regardless of drift.
    """

    comm_bytes_by_link: Mapping[str, int]
    rates: Mapping[str, float] = field(default_factory=lambda: dict(MODELED_LINK_BYTES_PER_S))
    cfg: DriftConfig = field(default_factory=DriftConfig)
    bus: Optional[bus_lib.Bus] = None

    block_ema: Optional[float] = None
    full_ema: Optional[float] = None
    block_n: int = 0
    full_n: int = 0
    drift_events: int = 0
    _since_drift: int = 0

    @property
    def modeled_extra_s(self) -> float:
        return sum(
            int(b) / float(self.rates[link])
            for link, b in self.comm_bytes_by_link.items()
            if int(b) > 0 and float(self.rates.get(link, 0.0)) > 0.0
        )

    def _update_ema(self, prev: Optional[float], x: float) -> float:
        if prev is None:
            return x
        beta = self.cfg.ema_beta
        return beta * prev + (1.0 - beta) * x

    def observe(self, step: int, phase: str, wall_s: float) -> Optional[dict]:
        """Record one step's wall time; returns the drift record if fired."""
        wall_s = float(wall_s)
        if phase == "block":
            self.block_ema = self._update_ema(self.block_ema, wall_s)
            self.block_n += 1
            return None
        if phase != "full":
            return None
        self.full_ema = self._update_ema(self.full_ema, wall_s)
        self.full_n += 1
        self._since_drift += 1

        modeled = self.modeled_extra_s
        if modeled < self.cfg.min_modeled_s:
            return None
        if self.block_n < self.cfg.warmup or self.full_n < self.cfg.warmup:
            return None
        measured = self.measured_extra_s
        if measured is None:
            return None
        # Clamp to a floor so "comm fully hidden" reads as a large speedup
        # ratio rather than a divide-by-zero.
        ratio = max(measured, 1e-9) / modeled
        t = self.cfg.threshold
        if 1.0 / t <= ratio <= t:
            return None
        if self._since_drift <= self.cfg.cooldown and self.drift_events > 0:
            return None
        self.drift_events += 1
        self._since_drift = 0
        rec = {
            "event": "drift",
            "step": int(step),
            "ratio": round(ratio, 4),
            "measured_extra_s": round(measured, 6),
            "modeled_extra_s": round(modeled, 6),
            "achieved_bytes_per_s": self.achieved_rates(),
            "modeled_bytes_per_s": {k: float(v) for k, v in self.rates.items()},
        }
        if self.bus is not None:
            self.bus.emit(rec)
        return rec

    @property
    def measured_extra_s(self) -> Optional[float]:
        if self.block_ema is None or self.full_ema is None:
            return None
        return self.full_ema - self.block_ema

    def achieved_rates(self) -> dict[str, float]:
        """Per-link achieved bytes/s implied by the measured extra time.

        All links scale by the common factor modeled/measured (one scalar
        measurement can't separate them); links with zero planned bytes
        are omitted.
        """
        measured = self.measured_extra_s
        modeled = self.modeled_extra_s
        out: dict[str, float] = {}
        if measured is None or modeled <= 0.0:
            return out
        scale = modeled / max(measured, 1e-9)
        for link, b in self.comm_bytes_by_link.items():
            if int(b) > 0:
                out[link] = round(float(self.rates[link]) * scale, 1)
        return out

    def report(self, bus: Optional[bus_lib.Bus] = None) -> dict:
        """Emit and return the ``comm_rates`` summary record."""
        measured = self.measured_extra_s
        rec = {
            "event": "comm_rates",
            "modeled_bytes_per_s": {k: float(v) for k, v in self.rates.items()},
            "achieved_bytes_per_s": self.achieved_rates(),
            "comm_bytes_by_link": {k: int(v) for k, v in self.comm_bytes_by_link.items()},
            "modeled_extra_s": round(self.modeled_extra_s, 6),
            "measured_extra_s": None if measured is None else round(measured, 6),
            "block_ema_s": None if self.block_ema is None else round(self.block_ema, 6),
            "full_ema_s": None if self.full_ema is None else round(self.full_ema, 6),
            "block_n": self.block_n,
            "full_n": self.full_n,
            "drift_events": self.drift_events,
        }
        target = bus if bus is not None else self.bus
        if target is not None:
            target.emit(rec)
        return rec


@dataclass
class ResidueDriftMonitor:
    """Per-residue drift monitor for the staggered full-step schedule.

    Staggering erases the full-minus-block wall delta :class:`DriftMonitor`
    measures -- every step runs the same mixed body shape, just a different
    due set. What survives is the *per-residue* structure: residue r's
    steps pay ``sum_link bytes[r][link] / rate[link]`` of modeled comm
    time, and residues with small bills are the compute baseline. The
    monitor keeps one wall-time EMA per residue, takes the residue with
    the smallest modeled bill as baseline, and compares each other
    residue's measured EMA delta against its modeled delta -- the same
    ratio-threshold/warmup/cooldown policy as the synchronous monitor.

    ``comm_bytes_by_residue`` is one ``{link: bytes}`` mapping per residue
    (``CommPlan.staggered_bytes_by_residue`` per link, or the per-residue
    exposed bytes of the compiled schedules). With balanced offsets the
    residue deltas are small by design, so on flat configs the
    ``min_modeled_s`` floor keeps the monitor silent by construction --
    exactly the desired behavior: a flat schedule has no burst to watch.
    """

    comm_bytes_by_residue: tuple
    rates: Mapping[str, float] = field(default_factory=lambda: dict(MODELED_LINK_BYTES_PER_S))
    cfg: DriftConfig = field(default_factory=DriftConfig)
    bus: Optional[bus_lib.Bus] = None

    emas: dict = field(default_factory=dict)      # residue -> wall EMA
    counts: dict = field(default_factory=dict)    # residue -> observations
    drift_events: int = 0
    _since_drift: int = 0

    def modeled_s(self, residue: int) -> float:
        bytes_by_link = self.comm_bytes_by_residue[residue]
        return sum(
            int(b) / float(self.rates[link])
            for link, b in bytes_by_link.items()
            if int(b) > 0 and float(self.rates.get(link, 0.0)) > 0.0
        )

    @property
    def period(self) -> int:
        return len(self.comm_bytes_by_residue)

    @property
    def baseline_residue(self) -> int:
        return min(range(self.period), key=lambda r: (self.modeled_s(r), r))

    def observe(self, step: int, phase: str, wall_s: float) -> Optional[dict]:
        """Record one staggered step's wall time; returns a drift rec if fired."""
        from repro_torch.core.program import parse_stagger_phase

        residue = parse_stagger_phase(phase)
        if residue is None or residue >= self.period:
            return None
        beta = self.cfg.ema_beta
        prev = self.emas.get(residue)
        self.emas[residue] = (
            float(wall_s) if prev is None
            else beta * prev + (1.0 - beta) * float(wall_s)
        )
        self.counts[residue] = self.counts.get(residue, 0) + 1

        base = self.baseline_residue
        if residue == base:
            return None
        self._since_drift += 1
        modeled = self.modeled_s(residue) - self.modeled_s(base)
        if modeled < self.cfg.min_modeled_s:
            return None
        if (self.counts.get(residue, 0) < self.cfg.warmup
                or self.counts.get(base, 0) < self.cfg.warmup):
            return None
        measured = self.emas[residue] - self.emas[base]
        ratio = max(measured, 1e-9) / modeled
        t = self.cfg.threshold
        if 1.0 / t <= ratio <= t:
            return None
        if self._since_drift <= self.cfg.cooldown and self.drift_events > 0:
            return None
        self.drift_events += 1
        self._since_drift = 0
        rec = {
            "event": "drift",
            "step": int(step),
            "residue": int(residue),
            "baseline_residue": int(base),
            "ratio": round(ratio, 4),
            "measured_extra_s": round(measured, 6),
            "modeled_extra_s": round(modeled, 6),
            "modeled_bytes_per_s": {k: float(v) for k, v in self.rates.items()},
        }
        if self.bus is not None:
            self.bus.emit(rec)
        return rec

    def achieved_rates(self) -> dict[str, float]:
        """Per-link achieved rates from the most comm-heavy residue's delta."""
        base = self.baseline_residue
        best, best_modeled = None, 0.0
        for r in range(self.period):
            if r == base or r not in self.emas or base not in self.emas:
                continue
            m = self.modeled_s(r) - self.modeled_s(base)
            if m > best_modeled:
                best, best_modeled = r, m
        if best is None or best_modeled < self.cfg.min_modeled_s:
            return {}
        measured = self.emas[best] - self.emas[base]
        scale = best_modeled / max(measured, 1e-9)
        return {
            link: round(float(self.rates[link]) * scale, 1)
            for link, b in self.comm_bytes_by_residue[best].items()
            if int(b) > 0
        }

    def report(self, bus: Optional[bus_lib.Bus] = None) -> dict:
        """Emit and return the ``comm_rates`` summary, broken down by residue."""
        rec = {
            "event": "comm_rates",
            "modeled_bytes_per_s": {k: float(v) for k, v in self.rates.items()},
            "achieved_bytes_per_s": self.achieved_rates(),
            "comm_bytes_by_residue": [
                {k: int(v) for k, v in by_link.items()}
                for by_link in self.comm_bytes_by_residue
            ],
            "baseline_residue": self.baseline_residue,
            "modeled_s_by_residue": [
                round(self.modeled_s(r), 6) for r in range(self.period)
            ],
            "ema_s_by_residue": {
                str(r): round(e, 6) for r, e in sorted(self.emas.items())
            },
            "counts_by_residue": {
                str(r): n for r, n in sorted(self.counts.items())
            },
            "drift_events": self.drift_events,
        }
        target = bus if bus is not None else self.bus
        if target is not None:
            target.emit(rec)
        return rec
