"""Profiling: running means of wall time, `torch.profiler` traces, and the
port's spans and counters (torch port of `neurad_tpu/utils/profiler.py`,
whose traces come from `jax.profiler`).

    @time_function                       # or: with time_function(name="block"): ...
    def render(...): ...
    with trace("outputs/trace"):         # writes outputs/trace/trace.json (Chrome / Perfetto)
        pipeline.train_step(state, *batch)

The means are printed at exit (`flush_profiler`). A timed function's time is
the host's: a CUDA call returns before the card has run it.

Spans and counters. `span(name, **args)` marks where the host is in the
program: while a `torch.profiler` profile runs it is a
`torch.profiler.record_function` range, a user annotation on the profiler's
clock beside the device's kernels; otherwise it is one shared null context
after a single check of the profiler's state (about 1 us). Names are
`<layer>.<what>`:

    closed_loop.request (request), closed_loop.patch_cameras   scripts/closed_loop.py
    pipeline.rays, pipeline.chunk (index), pipeline.to_host    pipelines/
    model.proposals, model.field, model.weights, model.decode,
    model.losses                                               NeuRAD (models/neurad.py, the pipeline's loss)
    model.actor_means, model.project, model.bin,
    model.composite, model.decode                              SplatAD camera and lidar (models/splatad.py,
                                                               ops/gaussian_rasterize.py)
    train.forward, train.backward, train.optimizer             ADPipeline.train_step, SplatADPipeline.train_step
    train.refine                                               SplatADPipeline's densification, when it runs

`count(name, value)` adds a Python int or a device scalar to a counter while
`counting()` is entered (`above=floor`: only the part above the floor), and
does nothing otherwise; `counter_values` reads the counters once, after the
window. Counters: `actor.samples_hit`,
`actor.capacity`, `actor.samples_dropped` (the compacted actor lookup),
`tiles.slots`, `tiles.slots_valid`, `tiles.pairs_dropped` (the camera
binning), `datamanager.gets`, `datamanager.gets_waited` (`iter_train`),
`nff.chunks` (every chunk `ADPipeline._chunked_nff` renders),
`nff.chunks_replayed` (those served by replaying CUDA graphs),
`nff.captures` (the captures of those graphs, `models/nff_graphs.py`),
`mcmc.refines` and `mcmc.relocated` (the MCMC relocations and the dead
slots they move, `model_components/strategy.py`).

A CUDA graph's capture counts into a `counting()` block of its own, so that
the counted values are computed inside the graph, and adds that block to
the current one after each replay (`Counters.count_again`); it notes the
spans its pieces open (`spans_opened`) and replays each piece in its span.

Rules for spans:
- only on the thread that drives the device: the profiler does not record
  ranges opened on a thread started after it (the datamanager's sampler
  threads), and a span on another thread would not nest in the device
  thread's;
- none inside an autograd `backward` function, which runs on autograd's
  thread;
- none takes a name of the benchmark's own spans: `window`, `render_image`,
  `update_actors`, `train_step`, `next(batches)`;
- a parent's children cover its host work without large holes, so that the
  device's idle time is put down to the innermost span that was open;
- the kernel entries the benchmark's launch recorders wrap keep their names:
  `ops.hash_encoding._forward`, `hash_grid_encode_bwd`,
  `ops.tile_composite._camera_forward`, `_camera_backward`, `_lidar_forward`,
  `_lidar_backward`.
"""

from __future__ import annotations

import atexit
import functools
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, List, Optional, Union

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
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        rec = _TIMES[self.name]
        rec[0] += time.perf_counter() - self._t0
        rec[1] += 1
        self._span.__exit__(*exc)


def flush_profiler() -> Dict[str, float]:
    """Mean seconds a call of every timed name, printed (slowest first)."""
    means = {k: total / max(count, 1) for k, (total, count) in _TIMES.items()}
    if means:
        print("[profiler] mean seconds per call:")
        for k, v in sorted(means.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {v:.4f}s")
    return means


atexit.register(flush_profiler)

_NO_SPAN = nullcontext()
_OPENED: Optional[List[str]] = None  # the names of the spans opened inside `spans_opened()`


def span(name: str, **args):
    """A `torch.profiler.record_function` range named `name` (its `args`,
    such as a chunk's index, in the range's arguments) while a profile runs;
    otherwise one shared null context (module docstring: the names and the
    rules)."""
    if _OPENED is not None:
        _OPENED.append(name)
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name, repr(args) if args else None)


@contextmanager
def spans_opened():
    """Yields the list of the names of the spans opened in the block, in
    order (an enclosing block's list is set aside meanwhile)."""
    global _OPENED
    outer, _OPENED = _OPENED, []
    try:
        yield _OPENED
    finally:
        _OPENED = outer


class Counters:
    """The counters of one `counting()` block. A Python int is added on the
    host; a device scalar joins its name's list and every `FOLD` of them are
    summed into one int64 accumulator on their device, so a count launches no
    kernel of its own and nothing waits for the device until
    `counter_values`. A counter is counted with `above` every time or never."""

    FOLD = 256

    def __init__(self):
        self.ints: Dict[str, int] = defaultdict(int)
        self.device: Dict[str, List[torch.Tensor]] = defaultdict(list)
        self.floors: Dict[str, List[int]] = {}  # the `above` of each device value, for the counters that have one

    def add(self, name: str, value: Union[int, torch.Tensor], above: Optional[int] = None) -> None:
        if not isinstance(value, torch.Tensor):
            self.ints[name] += int(value) if above is None else max(int(value) - above, 0)
            return
        self.device[name].append(value)
        if above is not None:
            self.floors.setdefault(name, []).append(above)
        if len(self.device[name]) > self.FOLD:
            self.device[name] = [self._total(name)]
            if name in self.floors:
                self.floors[name] = [0]

    def _total(self, name: str) -> torch.Tensor:
        values = torch.stack(self.device[name]).to(torch.int64)
        if name in self.floors:
            values = (values - torch.tensor(self.floors[name], device=values.device)).clamp_min(0)
        return values.sum()

    def count_again(self) -> None:
        """Add this block's counts to the current `counting()` block (nothing
        outside one), each device value cloned once: the counts of a captured
        CUDA graph, added after each replay, which the next replay overwrites."""
        if _COUNTERS is None:
            return
        for name, total in self.ints.items():
            _COUNTERS.add(name, total)
        clones: Dict[int, torch.Tensor] = {}
        for name, pending in self.device.items():
            floors = self.floors.get(name)
            for k, value in enumerate(pending):
                if id(value) not in clones:
                    clones[id(value)] = value.clone()
                _COUNTERS.add(name, clones[id(value)], None if floors is None else floors[k])

    def values(self) -> Dict[str, int]:
        out = dict(self.ints)
        for name, pending in self.device.items():
            if pending:
                out[name] = out.get(name, 0) + int(self._total(name).item())
        return out


_COUNTERS: Optional[Counters] = None


@contextmanager
def counting():
    """Counters on for the block (the counters of an enclosing block are set
    aside meanwhile); yields them for `counter_values`."""
    global _COUNTERS
    outer, _COUNTERS = _COUNTERS, Counters()
    try:
        yield _COUNTERS
    finally:
        _COUNTERS = outer


def is_counting() -> bool:
    """Whether `count` counts: a site that must compute its value first asks
    this, so that nothing is computed or launched while counting is off."""
    return _COUNTERS is not None


def count(name: str, value: Union[int, torch.Tensor], above: Optional[int] = None) -> None:
    """Add `value` (a Python int or a device scalar) to the counter `name`
    inside `counting()`, or with `above` only its part above that,
    max(value - above, 0), worked out when the counter is summed; nothing
    outside `counting()`."""
    if _COUNTERS is not None:
        _COUNTERS.add(name, value, above)


def counter_values(counters: Counters) -> Dict[str, int]:
    """Each counter's total, read once (waits for the device)."""
    return counters.values()


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
