"""Share of the camera binning's tile slots that hold a gaussian, in %:
100 x `tiles.slots_valid` / `tiles.slots`, the port's counters over the
window (layer: kernels)."""

from portbench.harness import spans


def install(records):
    return spans.counting(records)


def read(trace):
    return spans.ratio_pct(trace, "tiles.slots_valid", "tiles.slots")
