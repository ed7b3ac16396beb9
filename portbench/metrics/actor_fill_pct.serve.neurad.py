"""Share of the compacted actor lookups' capacity that samples inside an
actor's box fill, in %: 100 x `actor.samples_hit` / `actor.capacity`, the
port's counters over the window (above 100 the hits beyond the capacity keep
static features: `actor.samples_dropped`) (layer: model)."""

from portbench.harness import spans


def install(records):
    return spans.counting(records)


def read(trace):
    return spans.ratio_pct(trace, "actor.samples_hit", "actor.capacity")
