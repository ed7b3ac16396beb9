"""Share of the training loop's gets from the prefetch queue that found it
empty, in %: 100 x `datamanager.gets_waited` / `datamanager.gets`, the
port's counters over the window (layer: trainer and datamanager)."""

from portbench.harness import spans


def install(records):
    return spans.counting(records)


def read(trace):
    return spans.ratio_pct(trace, "datamanager.gets_waited", "datamanager.gets")
