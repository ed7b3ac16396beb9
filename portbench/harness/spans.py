"""The program's own spans and counters in a traced window: the device's idle
time put down to the program span the host was in, and the port's counters
read after the window.

The port opens `torch.profiler.record_function` ranges named
`<layer>.<what>` (`neurad_tpu_torch/utils/profiler.py`), which land in the
trace's spans beside the benchmark's own (`render_image`, `train_step`, ...)
and torch's annotations (`Optimizer.step#AdamW.step`). At each instant the
innermost open span is the one opened last among those still open; a torch
annotation counts towards the program span that encloses it, and an instant
with no program span open is outside the program. A window whose spans
hold no program span (a port that opens none) reads None, not 0.
"""

from __future__ import annotations

import contextlib
import fnmatch
import importlib
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.harness.trace import _union

PROGRAM = ("closed_loop.", "pipeline.", "model.", "train.")  # the layers of the port's span names
OUTSIDE = None  # the key of idle time with no program span open


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def idle_gaps(trace) -> List[Tuple[float, float]]:
    """The window's intervals with no device operation running."""
    lo, hi = trace.context["window"]
    gaps, cursor = [], lo
    for s, e in _union(trace.ops, lo, hi) + [(hi, hi)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    return gaps


def segments(spans) -> List[Tuple[float, float, tuple]]:
    """[(start, end, open program spans, outermost first)]: the window cut
    where a span opens or closes, each piece with the program spans open in
    it (empty where none is). A span that closes after the one opened after
    it (another thread's) does not end that one."""
    events = []
    for k, (name, start, end) in enumerate(spans):
        events.append((start, 1, k))
        events.append((end, 0, k))
    events.sort()
    out, open_, last = [], [], None
    for t, opening, k in events:
        if last is not None and t > last:
            out.append((last, t, tuple(spans[j][0] for j in open_ if is_program(spans[j][0]))))
        last = t
        if opening:
            open_.append(k)
        else:
            open_.remove(k)
    return out


def idle_by_span(trace) -> Optional[Dict[Optional[str], float]]:
    """{innermost open program span's name, or OUTSIDE: device idle seconds};
    the values add up to the window's idle time. None where no program span
    is in the window."""
    if not any(is_program(s[0]) for s in trace.spans):
        return None
    out: Dict[Optional[str], float] = {}
    for seconds, stack in _idle_pieces(trace):
        key = stack[-1] if stack else OUTSIDE
        out[key] = out.get(key, 0.0) + seconds
    return out


def idle_inside(trace, patterns: Iterable[str]) -> Optional[float]:
    """Device idle seconds while the innermost open program span, or a
    program span it is nested in, matches one of `patterns` (`fnmatch`:
    "model.*"); None where no program span is in the window."""
    if not any(is_program(s[0]) for s in trace.spans):
        return None
    patterns = tuple(patterns)
    return sum(seconds for seconds, stack in _idle_pieces(trace)
               if any(fnmatch.fnmatchcase(name, p) for name in stack for p in patterns))


def _idle_pieces(trace):
    """(idle seconds, open program spans) of each piece of the window where
    the device is idle."""
    gaps = idle_gaps(trace)
    lo, hi = trace.context["window"]
    pieces = [(max(s, lo), min(e, hi), stack) for s, e, stack in segments(trace.spans)]
    pieces = [p for p in pieces if p[1] > p[0]]
    # the window's stretches that no span covers are outside the program
    covered, cursor = [], lo
    for s, e, stack in pieces:
        if s > cursor:
            covered.append((cursor, s, ()))
        covered.append((s, e, stack))
        cursor = max(cursor, e)
    if cursor < hi:
        covered.append((cursor, hi, ()))
    i = 0
    for s, e, stack in covered:
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            overlap = min(e, gaps[j][1]) - max(s, gaps[j][0])
            if overlap > 0:
                yield overlap, stack
            j += 1


def per(trace, seconds: Optional[float], span: str) -> Optional[float]:
    """`seconds` in ms over the window's spans named `span` (requests or
    steps); None where either is missing."""
    n = trace.count(span)
    return 1e3 * seconds / n if seconds is not None and n else None


def mean_length_ms(trace, name: str) -> Optional[float]:
    """Mean host milliseconds of the window's spans named `name`."""
    lengths = [end - start for n, start, end in trace.spans if n == name]
    return 1e3 * sum(lengths) / len(lengths) if lengths else None


@contextlib.contextmanager
def counting(records: dict):
    """The port's counters on over the window (`profiler.counting`), their
    totals in records["counters"] after it; entered once however many
    readers ask. A port without counters counts nothing and raises nothing."""
    if "counters" in records:  # another reader entered it
        yield
        return
    profiler = importlib.import_module("neurad_tpu_torch.utils.profiler")
    enter = getattr(profiler, "counting", None)
    records["counters"] = {}
    if enter is None:
        yield
        return
    with enter() as counters:
        yield
    records["counters"] = profiler.counter_values(counters)


def ratio_pct(trace, part: str, whole: str) -> Optional[float]:
    """100 x counter `part` / counter `whole`; None where the port counted
    neither (or `whole` is 0)."""
    counters = trace.records.get("counters") or {}
    if not counters.get(whole):
        return None
    return 100.0 * counters.get(part, 0) / counters[whole]
