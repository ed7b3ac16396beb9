"""Share of the NeuRAD serve path's chunk renders served by replaying CUDA
graphs, in %: 100 x `nff.chunks_replayed` / `nff.chunks`, the port's
counters over the window (a port without them reads None) (layer: model)."""

from portbench.harness import spans


def install(records):
    return spans.counting(records)


def read(trace):
    return spans.ratio_pct(trace, "nff.chunks_replayed", "nff.chunks")
