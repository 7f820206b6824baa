"""LR schedules of the paper's experiments (counterpart of ``repro/core/schedule.py``).

Each schedule maps the host step count to a Python float.
"""

from __future__ import annotations

import math


def constant(lr: float):
    return lambda count: float(lr)


def cosine(peak_lr: float, total_steps: int, warmup_steps: int = 0, final_frac: float = 0.0):
    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / max(warmup_steps, 1)
        progress = (count - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * progress)))

    return schedule


def wsd(peak_lr: float, total_steps: int, warmup_steps: int = 0,
        decay_frac: float = 0.2, final_lr: float = 0.0):
    """Warmup-Stable-Decay with linear cooldown over the last ``decay_frac``."""
    decay_start = int(total_steps * (1.0 - decay_frac))

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / max(warmup_steps, 1)
        if count < decay_start:
            return float(peak_lr)
        progress = min(max((count - decay_start) / max(total_steps - decay_start, 1), 0.0), 1.0)
        return peak_lr + (final_lr - peak_lr) * progress

    return schedule
