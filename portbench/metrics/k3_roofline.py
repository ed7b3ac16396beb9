"""K3, the camera tile composite's backward (`camera_bwd_kernel`): the least
time of the window's first 2 launches over their device time, in % (layer:
kernels)."""

from portbench.harness import launches, least_work_splat


def install(records):
    return least_work_splat.camera_backwards(records)


def read(trace):
    least_work_splat.counted(trace.records, "k3")
    return launches.roofline_pct(trace, "k3", "camera_bwd_kernel")
