"""Profiling: running means of wall time, and `torch.profiler` traces
(torch port of `neurad_tpu/utils/profiler.py`, whose traces come from
`jax.profiler`).

    @time_function                       # or: with time_function(name="block"): ...
    def render(...): ...
    with trace("outputs/trace"):         # writes outputs/trace/trace.json (Chrome / Perfetto)
        pipeline.train_step(state, *batch)

The means are printed at exit (`flush_profiler`). A timed function's time is
the host's: a CUDA call returns before the card has run it.
"""

from __future__ import annotations

import atexit
import functools
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

import torch

_TIMES: Dict[str, list] = defaultdict(lambda: [0.0, 0])


def time_function(fn=None, *, name: Optional[str] = None):
    """Decorator (or, without a function, a context manager) that adds each
    call's wall time to the running mean of `name` (default: the function's
    qualified name)."""
    if fn is None:
        return _TimeBlock(name or "block")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _TimeBlock(name or fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


class _TimeBlock:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        rec = _TIMES[self.name]
        rec[0] += time.perf_counter() - self._t0
        rec[1] += 1


def flush_profiler() -> Dict[str, float]:
    """Mean seconds a call of every timed name, printed (slowest first)."""
    means = {k: total / max(count, 1) for k, (total, count) in _TIMES.items()}
    if means:
        print("[profiler] mean seconds per call:")
        for k, v in sorted(means.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {v:.4f}s")
    return means


atexit.register(flush_profiler)


@contextmanager
def trace(log_dir: str):
    """Trace the block with `torch.profiler` (the host, and the card where
    there is one) and write `<log_dir>/trace.json`, a Chrome trace. Yields the
    profiler (its `key_averages()` gives the time by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path / "trace.json"))
