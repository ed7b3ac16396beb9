"""Learning-rate schedules as plain functions of the step (torch port of
`neurad_tpu/engine/schedulers.py`). A schedule returns the absolute learning
rate as a Python float.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence


def exponential_decay_schedule(
    lr_init: float,
    lr_final: Optional[float] = None,
    max_steps: int = 100000,
    warmup_steps: int = 0,
    lr_pre_warmup: float = 1e-8,
    ramp: str = "cosine",
) -> Callable[[int], float]:
    """Warm-up ramp (cosine or linear) from `lr_pre_warmup`, then log-linear
    decay from `lr_init` to `lr_final` at `max_steps`."""
    final = lr_init if lr_final is None else lr_final

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            frac = min(max(step / warmup_steps, 0.0), 1.0)
            shape = math.sin(0.5 * math.pi * frac) if ramp == "cosine" else frac
            return lr_pre_warmup + (lr_init - lr_pre_warmup) * shape
        t = min(max((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return math.exp(math.log(lr_init) * (1.0 - t) + math.log(final) * t)

    return schedule


def multistep_schedule(lr_init: float, milestones: Sequence[int] = (1000000,), gamma: float = 0.33
                       ) -> Callable[[int], float]:
    """`lr_init` times `gamma` for every milestone the step has reached."""
    milestones = tuple(milestones)

    def schedule(step) -> float:
        return lr_init * gamma ** sum(step >= m for m in milestones)

    return schedule


def cosine_decay_schedule(
    lr_init: float, warm_up_end: int = 5000, learning_rate_alpha: float = 0.05, max_steps: int = 300000
) -> Callable[[int], float]:
    """Linear warm-up to `lr_init` over `warm_up_end` steps, then cosine decay
    to `learning_rate_alpha * lr_init` at `max_steps`."""

    def schedule(step) -> float:
        step = float(step)
        if step < warm_up_end:
            return lr_init * step / max(warm_up_end, 1)
        progress = min(max((step - warm_up_end) / max(max_steps - warm_up_end, 1), 0.0), 1.0)
        return lr_init * ((math.cos(math.pi * progress) + 1.0) * 0.5 * (1.0 - learning_rate_alpha)
                          + learning_rate_alpha)

    return schedule
