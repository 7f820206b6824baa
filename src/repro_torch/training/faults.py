"""Deterministic fault injection for resilience testing (counterpart of
``repro/training/faults.py``, with the same grammar).

Every recovery path in ``resilience``/``checkpoint`` is exercised, not
assumed: a :class:`FaultPlan` names exactly which fault fires at which step,
so tests and the chaos harness (``repro_torch.scripts.chaos_run``) can
replay the same disaster and compare against a clean run.

Fault kinds:

* ``nan_grads@K`` / ``inf_grads@K`` -- in the step: every gradient leaf
  becomes NaN/Inf at step K (``train_step(..., fault=)``; steps without a
  fault run the clean step).
* ``spike_loss@KxF`` -- in the step: the loss is multiplied by F at step K
  (trips the guard's EMA spike detector without any non-finite values).
* ``kill_in_save@K`` -- process-level: SIGKILL the process from inside
  ``checkpoint.save`` at the first save with ``step >= K``, *after* the
  snapshot's tmp dir is fully written but *before* the atomic rename --
  the window a non-atomic writer corrupts.
* ``kill_mid_save@K`` -- same, but between the array-file writes, leaving a
  torn tmp dir (which restore must never pick up).

Serving-path faults (``repro_torch.serving.engine`` fires them):

* ``slow_step@NxS`` -- host-level: the engine sleeps S wall seconds (default
  0.05) inside scheduler iteration N, simulating a straggler / preempted
  decode step. Virtual-clock event order is untouched, so replays stay
  deterministic; the stall shows up in wall-time spans.
* ``corrupt_cache@N`` -- device-level: at iteration N the engine poisons one
  active slot's first KV block with NaN. The engine's per-slot logit guard
  must cancel exactly that request (``cancel`` event, reason ``corrupt``)
  and scrub its blocks; co-batched requests are unaffected.
* ``kill_in_decode@N`` -- process-level: SIGKILL from inside the decode loop
  at the first scheduler iteration >= N -- the telemetry trail must survive
  (the chaos harness's ``telemetry_failures`` containment check).

File-corruption helpers (:func:`truncate_file`, :func:`bitflip_file`)
simulate disk-level damage to existing snapshots; the checkpoint layer's
CRC manifest must reject both.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib

GRAD_KINDS = ("nan_grads", "inf_grads", "spike_loss")
SERVE_KINDS = ("slow_step", "corrupt_cache")
KILL_KINDS = ("kill_in_save", "kill_mid_save", "kill_in_decode")
KINDS = GRAD_KINDS + SERVE_KINDS + KILL_KINDS

# crash points, in write order (checkpoint) / dispatch order (serving)
_KILL_POINT = {
    "kill_mid_save": "checkpoint.mid_write",
    "kill_in_save": "checkpoint.pre_finalize",
    "kill_in_decode": "serve.decode",
}


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    scale: float = 8.0  # spike_loss multiplier / slow_step stall seconds

    def spec(self) -> str:
        if self.kind in ("spike_loss", "slow_step"):
            return f"{self.kind}@{self.step}x{self.scale:g}"
        return f"{self.kind}@{self.step}"


class FaultPlan:
    """Parsed, deterministic schedule of faults.

    Spec grammar: comma-separated ``kind@step`` items, with an optional
    ``xSCALE`` suffix for ``spike_loss`` -- e.g.
    ``"nan_grads@7,spike_loss@9x8,kill_in_save@12"``.
    """

    def __init__(self, faults):
        self.faults = tuple(faults)
        for f in self.faults:
            if f.kind not in KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r} (known: {KINDS})")
        # kill faults fire once per process: on the first save whose step
        # reaches them (saves are periodic, so an exact step match would
        # silently never fire).
        self._fired: set[Fault] = set()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            try:
                kind, rest = item.split("@", 1)
                # per-kind scale defaults: spike multiplier vs stall seconds
                scale = 0.05 if kind == "slow_step" else 8.0
                if "x" in rest:
                    rest, s = rest.split("x", 1)
                    scale = float(s)
                faults.append(Fault(kind=kind, step=int(rest), scale=scale))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec item {item!r} (want kind@step[xSCALE]): {e}"
                ) from None
        return cls(faults)

    def spec(self) -> str:
        return ",".join(f.spec() for f in self.faults)

    def grad_fault(self, step: int) -> Optional[Fault]:
        """The in-step fault scheduled for this step, if any."""
        for f in self.faults:
            if f.kind in GRAD_KINDS and f.step == step:
                return f
        return None

    def serve_fault(self, step: int) -> Optional[Fault]:
        """The serving-path fault scheduled for scheduler iteration ``step``
        (``slow_step`` / ``corrupt_cache``; kills go through
        :func:`crash_point` with point ``"serve.decode"``)."""
        for f in self.faults:
            if f.kind in SERVE_KINDS and f.step == step:
                return f
        return None

    def without_kills(self) -> "FaultPlan":
        """The plan a restarted process should run under: replayed steps
        re-inject grad faults deterministically, but re-arming a kill at a
        step the resumed run will pass again would crash-loop forever."""
        return FaultPlan(f for f in self.faults if f.kind not in KILL_KINDS)

    def take_kill(self, point: str, step: Optional[int]) -> bool:
        """True exactly once per armed kill fault matching this crash point."""
        if step is None:
            return False
        for f in self.faults:
            if (f.kind in KILL_KINDS and _KILL_POINT[f.kind] == point
                    and step >= f.step and f not in self._fired):
                self._fired.add(f)
                return True
        return False


# ---------------------------------------------------------------------------
# Process-global active plan + crash points
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None


def set_active(plan: Optional[FaultPlan]) -> None:
    global _active
    _active = plan


def active() -> Optional[FaultPlan]:
    return _active


def crash_point(point: str, step: Optional[int] = None) -> None:
    """Called from ``checkpoint.save`` at its crash-injection points, and from
    the serving engine's decode loop (``"serve.decode"``).

    SIGKILLs the current process -- no atexit, no cleanup, exactly what a
    preemption looks like -- when either the active :class:`FaultPlan` or
    the ``REPRO_KILL_IN_SAVE`` / ``REPRO_KILL_MID_SAVE`` env vars (a step
    threshold; crosses the subprocess boundary without a flag) arm it.
    """
    kill = _active is not None and _active.take_kill(point, step)
    env = {
        "checkpoint.pre_finalize": os.environ.get("REPRO_KILL_IN_SAVE"),
        "checkpoint.mid_write": os.environ.get("REPRO_KILL_MID_SAVE"),
        "serve.decode": os.environ.get("REPRO_KILL_IN_DECODE"),
    }.get(point)
    if env is not None and step is not None and step >= int(env):
        kill = True
    if kill:
        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# In-step injection
# ---------------------------------------------------------------------------

def inject(fault: Fault, loss, grads, metrics):
    """Apply an in-step fault to (loss, grads, metrics).

    Only a step given a fault calls this, so the clean step's numerics are
    untouched.
    """
    if fault.kind == "nan_grads":
        grads = tree_lib.tree_map(lambda g: torch.full_like(g, float("nan")), grads)
    elif fault.kind == "inf_grads":
        grads = tree_lib.tree_map(lambda g: torch.full_like(g, float("inf")), grads)
    elif fault.kind == "spike_loss":
        loss = loss * torch.tensor(fault.scale, dtype=torch.float32, device=loss.device)
        metrics = dict(metrics)
        metrics["loss"] = loss
    else:
        raise ValueError(f"{fault.kind!r} is not an in-step fault")
    return loss, grads, metrics


# ---------------------------------------------------------------------------
# On-disk corruption (simulated disk damage to an existing snapshot)
# ---------------------------------------------------------------------------

def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate ``path`` to a fraction of its size; returns the new size."""
    size = os.path.getsize(path)
    keep = int(size * keep_fraction)
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def bitflip_file(path: str, *, offset: Optional[int] = None, seed: int = 0) -> int:
    """Flip one bit of ``path`` (deterministic under ``seed``); returns the
    byte offset flipped. Defaults to a byte in the middle half of the file
    so it lands in array data rather than container headers -- though the
    checksum layer must reject either."""
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    if offset is None:
        offset = int(rng.integers(size // 4, max(size // 4 + 1, 3 * size // 4)))
    bit = int(rng.integers(0, 8))
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([byte ^ (1 << bit)]))
    return offset
