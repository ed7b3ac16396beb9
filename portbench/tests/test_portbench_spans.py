"""The readers of the program's spans and counters (`harness/spans.py` and
the metrics that use it) on hand-built traces, against hand-computed
numbers."""

from __future__ import annotations

import pytest

from portbench.harness import cell as C
from portbench.harness import spans
from portbench.harness.trace import TraceData

# Serving, window [0, 10] s: the device busy in [0, 1], [3, 4], [6, 7]; idle [1, 3], [4, 6], [7, 10] (7 s).
SERVE_OPS = [("k", 0.0, 1.0), ("k", 3.0, 1.0), ("k", 6.0, 1.0)]
SERVE_SPANS = [
    ("render_image", 0.5, 9.0),
    ("closed_loop.request", 0.6, 8.8),
    ("closed_loop.patch_cameras", 0.7, 1.5),  # idle 0.5
    ("pipeline.rays", 1.5, 2.0),  # idle 0.5
    ("pipeline.chunk", 2.0, 5.0),  # its own time idle 0.5 + 1.0
    ("model.field", 2.5, 3.5),  # idle 0.5
    ("model.decode", 5.0, 5.5),  # idle 0.5
    ("pipeline.to_host", 5.5, 8.0),  # idle 0.5 + 1.0
]  # the request's own time idle 0.8; render_image's own 0.2 and [9, 10] outside the program
SERVE_IDLE = {"closed_loop.patch_cameras": 0.5, "pipeline.rays": 0.5, "pipeline.chunk": 1.5, "model.field": 0.5,
              "model.decode": 0.5, "pipeline.to_host": 1.5, "closed_loop.request": 0.8, spans.OUTSIDE: 1.2}

# Training, window [0, 10] s: busy [0, 2], [5, 6]; idle [2, 5], [6, 10] (7 s).
TRAIN_OPS = [("k", 0.0, 2.0), ("k", 5.0, 1.0)]
TRAIN_SPANS = [
    ("train_step", 0.0, 9.0),
    ("train.forward", 0.1, 4.0),  # idle [2, 4], the chunk's [2, 3] included
    ("pipeline.chunk", 0.2, 3.0),
    ("train.backward", 4.0, 5.5),  # idle [4, 5]
    ("train.optimizer", 5.5, 8.5),  # idle [6, 8.5], torch's annotation inside it included
    ("Optimizer.step#AdamW.step", 5.6, 8.0),
    ("next(batches)", 9.0, 9.5),
]  # [8.5, 10] outside the program


def _trace(ops, span_list, records=None) -> TraceData:
    return TraceData(window_s=10.0, busy_s=sum(d for _, _, d in ops), ops=ops,
                     spans=sorted(span_list, key=lambda s: s[1]),
                     records=records or {}, context={"window": (0.0, 10.0)})


def _read(metric: str, trace) -> float:
    return C.load_reader(metric).read(trace)


def test_idle_goes_to_the_innermost_program_span_and_adds_up():
    trace = _trace(SERVE_OPS, SERVE_SPANS)
    split = spans.idle_by_span(trace)
    assert split.keys() == SERVE_IDLE.keys()
    for name, seconds in SERVE_IDLE.items():
        assert split[name] == pytest.approx(seconds), name
    assert sum(split.values()) == pytest.approx(trace.window_s - trace.busy_s)


def test_a_nested_span_counts_for_its_ancestors():
    trace = _trace(SERVE_OPS, SERVE_SPANS)
    assert spans.idle_inside(trace, ("pipeline.chunk",)) == pytest.approx(2.0)  # the field's idle inside the chunk
    assert spans.idle_inside(trace, ("model.*",)) == pytest.approx(1.0)
    assert spans.idle_inside(trace, ("closed_loop.request",)) == pytest.approx(7.0 - 1.2)


@pytest.mark.parametrize("metric, value", [
    ("prep_idle_ms.serve.neurad", 1000.0),  # patch_cameras 0.5 + rays 0.5, one request
    ("prep_idle_ms.serve.splatad", 1000.0),
    ("model_idle_ms.serve.neurad", 2500.0),  # the chunk 2.0 (its field's 0.5 in it) + decode 0.5
    ("model_idle_ms.serve.splatad", 2500.0),
    ("to_host_ms.serve.neurad", 2500.0),  # the span's length, [5.5, 8.0]
    ("to_host_ms.serve.splatad", 2500.0),
])
def test_serve_readers(metric, value):
    assert _read(metric, _trace(SERVE_OPS, SERVE_SPANS)) == pytest.approx(value)


def test_serve_readers_divide_by_the_requests():
    second = [(n, s + 10.0, e + 10.0) for n, s, e in SERVE_SPANS]
    ops = SERVE_OPS + [(n, s + 10.0, d) for n, s, d in SERVE_OPS]
    trace = TraceData(window_s=20.0, busy_s=6.0, ops=ops, spans=SERVE_SPANS + second, records={},
                      context={"window": (0.0, 20.0)})
    assert _read("prep_idle_ms.serve.neurad", trace) == pytest.approx(1000.0)
    assert _read("model_idle_ms.serve.neurad", trace) == pytest.approx(2500.0)
    assert sum(spans.idle_by_span(trace).values()) == pytest.approx(14.0)


@pytest.mark.parametrize("metric, value", [
    ("forward_idle_ms.train", 2000.0),
    ("backward_idle_ms.train", 1000.0),
    ("optimizer_idle_ms.train", 2500.0),  # Optimizer.step#AdamW.step's 2.0 counts towards train.optimizer
])
def test_train_readers(metric, value):
    assert _read(metric, _trace(TRAIN_OPS, TRAIN_SPANS)) == pytest.approx(value)


def test_torch_annotations_and_gaps_outside_every_span():
    split = spans.idle_by_span(_trace(TRAIN_OPS, TRAIN_SPANS))
    assert "Optimizer.step#AdamW.step" not in split
    assert split == pytest.approx({"pipeline.chunk": 1.0, "train.forward": 1.0, "train.backward": 1.0,
                                   "train.optimizer": 2.5, spans.OUTSIDE: 1.5})


@pytest.mark.parametrize("metric", ["prep_idle_ms.serve.neurad", "model_idle_ms.serve.splatad",
                                    "to_host_ms.serve.neurad", "forward_idle_ms.train", "backward_idle_ms.train",
                                    "optimizer_idle_ms.train", "actor_fill_pct.serve.neurad",
                                    "tile_fill_pct.serve.splatad", "queue_waited_pct.train"])
def test_a_window_without_program_spans_reads_none(metric):
    """The benchmark's and torch's spans alone (a port that opens none, and counts nothing)."""
    bare = [s for s in SERVE_SPANS + TRAIN_SPANS if not spans.is_program(s[0])]
    trace = _trace(SERVE_OPS, bare, records={"counters": {}})
    assert spans.idle_by_span(trace) is None
    assert _read(metric, trace) is None


@pytest.mark.parametrize("metric, counters, value", [
    ("actor_fill_pct.serve.neurad", {"actor.samples_hit": 300, "actor.capacity": 1200, "actor.samples_dropped": 0},
     25.0),
    ("actor_fill_pct.serve.neurad", {"actor.samples_hit": 1500, "actor.capacity": 1200,
                                     "actor.samples_dropped": 300}, 125.0),
    ("tile_fill_pct.serve.splatad", {"tiles.slots": 2048, "tiles.slots_valid": 512, "tiles.pairs_dropped": 3}, 25.0),
    ("queue_waited_pct.train", {"datamanager.gets": 40, "datamanager.gets_waited": 10}, 25.0),
    ("queue_waited_pct.train", {"datamanager.gets": 40}, 0.0),
])
def test_counter_readers(metric, counters, value):
    assert _read(metric, _trace(SERVE_OPS, SERVE_SPANS, records={"counters": counters})) == pytest.approx(value)


def test_counting_is_entered_once_and_read_after_the_window():
    from neurad_tpu_torch.utils import profiler

    records: dict = {}
    readers = [C.load_reader(m) for m in ("actor_fill_pct.serve.neurad", "queue_waited_pct.train")]
    with readers[0].install(records), readers[1].install(records):
        profiler.count("datamanager.gets", 4)
        profiler.count("datamanager.gets_waited", 1)
    assert not profiler.is_counting()
    assert records["counters"] == {"datamanager.gets": 4, "datamanager.gets_waited": 1}


def test_a_port_without_counters_counts_nothing_and_raises_nothing(monkeypatch):
    from neurad_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "counting")
    records: dict = {}
    with C.load_reader("queue_waited_pct.train").install(records):
        pass
    assert _read("queue_waited_pct.train", _trace(TRAIN_OPS, TRAIN_SPANS, records)) is None
