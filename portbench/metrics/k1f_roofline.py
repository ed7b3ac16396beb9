"""K1f, the hash-grid lookup kernel (`hash_grid_fwd_kernel`): the least time
of the window's first 16 launches over their device time, in % (layer:
kernels)."""

from portbench.harness import launches


def install(records):
    return launches.hash_lookups(records)


def read(trace):
    return launches.roofline_pct(trace, "k1f", "hash_grid_fwd_kernel")
