"""Span-based timing: host-side timers and profiler stage annotations.

Counterpart of ``repro/obs/spans.py``. Two layers:

* :func:`span` -- a host-side context manager timing step / checkpoint /
  resume regions with ``time.perf_counter``. Spans nest via a thread-local
  stack; a child records its parent's name so ``obs_report`` can attribute
  e.g. ``checkpoint.save`` time inside a ``step`` span. Each span emits one
  ``{"event": "span"}`` record on exit. A CUDA host clock sees device work
  only up to its launch: pass a ``sync`` callable (the launcher passes
  ``torch.cuda.synchronize(device)`` under ``--obs-block``) when the span
  must include device completion; by default nothing is synchronized and
  instrumentation adds no device round trip.
* :func:`stage_scope` -- ``torch.profiler.record_function``, the
  counterpart of the reference's ``jax.named_scope``: it only names a
  region in a profiler trace (``--profile-steps``) and changes no result.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch.obs import bus as bus_lib

_local = threading.local()


def _stack() -> list["Span"]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def current_span() -> "Span | None":
    stack = _stack()
    return stack[-1] if stack else None


@dataclass
class Span:
    """One timed region; ``dur_s`` is populated when the context exits."""

    name: str
    attrs: dict[str, Any] = field(default_factory=dict)
    parent: "Span | None" = None
    dur_s: float | None = None

    def set(self, **attrs: Any) -> None:
        """Attach attributes after entry (e.g. the active slots of a decode)."""
        self.attrs.update(attrs)


@contextlib.contextmanager
def span(
    bus: bus_lib.Bus | None,
    name: str,
    sync: Callable[[], Any] | None = None,
    **attrs: Any,
) -> Iterator[Span]:
    """Time a region and emit a ``span`` record on exit.

    ``sync`` (if given) runs inside the timed region just before the clock
    stops. The emitted record is ``{"event": "span", "name": ..., "dur_s":
    ..., **attrs}`` plus ``"parent"`` when nested.
    """
    sp = Span(name=name, attrs=dict(attrs), parent=current_span())
    _stack().append(sp)
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        if sync is not None:
            sync()
        sp.dur_s = time.perf_counter() - t0
        _stack().pop()
        if bus is not None:
            rec: dict[str, Any] = {"event": "span", "name": name, "dur_s": round(sp.dur_s, 6)}
            if sp.parent is not None:
                rec["parent"] = sp.parent.name
            rec.update(sp.attrs)
            bus.emit(rec)


def record_span(bus: bus_lib.Bus | None, name: str, dur_s: float, **attrs: Any) -> None:
    """Emit a span record for a duration measured elsewhere (e.g. a
    collective's wall read around the call)."""
    if bus is None:
        return
    bus.emit({"event": "span", "name": name, "dur_s": round(float(dur_s), 6), **attrs})


def stage_scope(name: str):
    """A named region of a ``torch.profiler`` trace; no effect on results."""
    return torch.profiler.record_function(name)


def parse_profile_window(spec: str) -> tuple[int, int]:
    """Parse ``--profile-steps A:B`` into an inclusive-exclusive window."""
    try:
        a_s, b_s = spec.split(":")
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(f"--profile-steps expects A:B (got {spec!r})") from None
    if a < 0 or b <= a:
        raise ValueError(f"--profile-steps window must satisfy 0 <= A < B (got {spec!r})")
    return a, b


def percentiles(values, qs=(50, 95, 99)) -> dict[str, float]:
    """Nearest-rank percentiles, keyed ``p50``/``p95``/... Empty input -> {}."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {}
    out = {}
    for q in qs:
        idx = min(len(vals) - 1, max(0, math.ceil(q / 100.0 * len(vals)) - 1))
        out[f"p{q}"] = vals[idx]
    return out
