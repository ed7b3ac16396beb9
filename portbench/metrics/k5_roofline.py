"""K5, the lidar tile composite's backward (`lidar_bwd_kernel`): the least
time of the window's first 2 launches over their device time, in % (layer:
kernels)."""

from portbench.harness import launches, least_work_splat


def install(records):
    return least_work_splat.lidar_backwards(records)


def read(trace):
    least_work_splat.counted(trace.records, "k5")
    return launches.roofline_pct(trace, "k5", "lidar_bwd_kernel")
