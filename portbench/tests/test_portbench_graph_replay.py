"""The reader of `graph_replay_pct.serve.neurad` on hand-built traces: the
port's counters of the chunk renders, and a port that counts none."""

from __future__ import annotations

import pytest

from portbench.harness import cell as C
from portbench.harness.trace import TraceData

METRIC = "graph_replay_pct.serve.neurad"


def _trace(counters) -> TraceData:
    return TraceData(window_s=10.0, busy_s=5.0, ops=[("k", 0.0, 5.0)], spans=[("render_image", 0.0, 9.0)],
                     records={} if counters is None else {"counters": counters}, context={"window": (0.0, 10.0)})


@pytest.mark.parametrize("counters, value", [
    ({"nff.chunks": 8, "nff.chunks_replayed": 8}, 100.0),
    ({"nff.chunks": 8, "nff.chunks_replayed": 6, "nff.captures": 1}, 75.0),
    ({"nff.chunks": 8}, 0.0),
    ({}, None),
    (None, None),
])
def test_the_replay_share_of_the_chunk_renders(counters, value):
    got = C.load_reader(METRIC).read(_trace(counters))
    assert got == (None if value is None else pytest.approx(value))


def test_the_reader_counts_over_the_window():
    from neurad_tpu_torch.utils import profiler

    records: dict = {}
    with C.load_reader(METRIC).install(records):
        for _ in range(8):
            profiler.count("nff.chunks", 1)
            profiler.count("nff.chunks_replayed", 1)
    assert C.load_reader(METRIC).read(_trace(records["counters"])) == pytest.approx(100.0)
