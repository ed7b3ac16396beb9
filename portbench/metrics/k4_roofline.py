"""K4, the lidar tile composite (`lidar_fwd_kernel`): the least time of the
window's first 2 launches over their device time, in % (layer: kernels)."""

from portbench.harness import launches, least_work_splat


def install(records):
    return least_work_splat.lidar_forwards(records)


def read(trace):
    least_work_splat.counted(trace.records, "k4")
    return launches.roofline_pct(trace, "k4", "lidar_fwd_kernel")
