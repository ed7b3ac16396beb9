"""The traced window: `torch.profiler` over the measured window, the
benchmark's own host spans around the calls it makes, and what the
per-layer readers take from them.

Spans are `torch.profiler.record_function` ranges named after the call they
surround (`render_image`, `update_actors`, ...) inside one `window` range; the
device's operations are the profiler's CUDA activity (kernels, copies, fills).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "window"
_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class TraceData:
    """What a per-layer reader reads. Times in seconds, in the profiler's clock."""

    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]  # every device operation in the window: (name, start, duration)
    spans: List[Tuple[str, float, float]]  # the benchmark's host spans: (name, start, end)
    records: dict  # what the readers' install hooks recorded
    context: dict  # the cell's: config, family module, span names, peaks, the window's bounds

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if not o[0].startswith(_COPY_PREFIXES)]

    def count(self, span: str) -> int:
        return sum(1 for s in self.spans if s[0] == span)

    def kernels_named(self, fragment: str) -> List[Tuple[str, float, float]]:
        return [k for k in self.kernels if fragment in k[0]]


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its argument list, at most `limit` characters."""
    head = name.replace("(anonymous namespace)", "{anon}").split("(", 1)[0].strip() or name
    return head[:limit]


class Tracer:
    """Profiles the window when enabled; otherwise every span is free."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.records: dict = {}

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=activities, record_shapes=False)
        self._prof.start()
        try:
            with torch.profiler.record_function(WINDOW):
                yield
            if cuda:
                torch.cuda.synchronize()
        finally:
            self._prof.stop()

    def data(self, context: dict) -> Optional[TraceData]:
        """The window's trace, None where it was not traced."""
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        ops, spans, window = [], [], None
        names = set(context.get("span_names", ())) | {WINDOW}
        for e in events:
            start, dur, name = e.start_ns() * 1e-9, e.duration_ns() * 1e-9, e.name()
            annotation = e.is_user_annotation() or name in names
            if e.device_type().name == "CUDA":
                if not annotation:  # a host span's image on the device's timeline is no device work
                    ops.append((name, start, dur))
            elif name == WINDOW:
                window = (start, start + dur)
            elif annotation:
                spans.append((name, start, start + dur))
        if window is None:
            return None
        lo, hi = window
        # device work the window's last host span waited for may end after it: the window closes with it
        hi = max([hi] + [s + d for _, s, d in ops if s < hi])
        ops = sorted((o for o in ops if o[1] + o[2] > lo and o[1] < hi), key=lambda o: o[1])
        spans = sorted((s for s in spans if s[2] > lo and s[1] < hi), key=lambda s: s[1])
        busy = sum(e - s for s, e in _union(ops, lo, hi))
        return TraceData(window_s=hi - lo, busy_s=busy, ops=ops, spans=spans, records=self.records,
                         context=dict(context, window=(lo, hi)))


def _union(ops, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The device's busy intervals: the union of its operations, within [lo, hi]."""
    out: List[List[float]] = []
    for _, s, d in ops:
        s, e = max(s, lo), min(s + d, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def breakdown(trace: TraceData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle gaps
    named by the host span the benchmark was in when each began."""
    by_name: Dict[str, float] = {}
    for name, _, d in trace.ops:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + d
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.context["window"]
    busy = _union(trace.ops, lo, hi)
    gaps, cursor = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    starts = [sp[1] for sp in trace.spans]
    idle = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        i = bisect.bisect_right(starts, s) - 1  # the benchmark's spans follow one another
        name = trace.spans[i][0] if i >= 0 and trace.spans[i][2] > s else "between spans"
        idle.append([name, e - s])
    return {"device_ops": [[n, s] for n, s in device_ops], "idle_gaps": idle}
