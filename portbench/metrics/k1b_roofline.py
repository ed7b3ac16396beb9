"""K1b, the hash-grid lookup's backward kernel (`hash_grid_bwd_kernel`): the
least time of the window's first 14 launches over their device time, in %
(layer: kernels)."""

from portbench.harness import launches


def install(records):
    return launches.hash_lookup_backwards(records)


def read(trace):
    return launches.roofline_pct(trace, "k1b", "hash_grid_bwd_kernel")
