"""Learning-rate schedules (pure functions of the integer step count)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda count: float(lr)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def sched(count):
        c = float(count)
        if c < warmup_steps:
            return peak_lr * c / max(warmup_steps, 1)
        progress = min(max((c - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * progress)))

    return sched


def linear_warmup(peak_lr: float, warmup_steps: int):
    def sched(count):
        return peak_lr * min(1.0, float(count) / max(warmup_steps, 1))

    return sched
