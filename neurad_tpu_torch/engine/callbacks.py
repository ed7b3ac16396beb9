"""Training callbacks: hooks before and after each iteration and after
training (torch port of `neurad_tpu/engine/callbacks.py`). A callback is a
host function `fn(state, step) -> state or None` (None keeps the state);
`update_every_num_iters` or an explicit `iters` decides the steps it runs at.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Sequence


class TrainingCallbackLocation(enum.Enum):
    BEFORE_TRAIN_ITERATION = "before"
    AFTER_TRAIN_ITERATION = "after"
    AFTER_TRAIN = "end"


@dataclasses.dataclass
class TrainingCallback:
    """One hook: fn(state, step) -> new state or None, at `where_to_run`."""

    where_to_run: Sequence[TrainingCallbackLocation]
    func: Callable
    update_every_num_iters: Optional[int] = 1
    iters: Optional[Sequence[int]] = None  # explicit steps, in place of the cadence

    def run_callback_at_location(self, state, step: int, location: TrainingCallbackLocation):
        if location not in self.where_to_run:
            return state
        if self.iters is not None:
            due = step in self.iters
        else:
            due = bool(self.update_every_num_iters) and step % self.update_every_num_iters == 0
        if not due:
            return state
        out = self.func(state, step)
        return state if out is None else out


def run_callbacks(callbacks: List[TrainingCallback], state, step: int, location: TrainingCallbackLocation):
    for cb in callbacks:
        state = cb.run_callback_at_location(state, step, location)
    return state
