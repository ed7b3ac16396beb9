"""K2, the camera tile composite (`camera_fwd_kernel`): the least time of the
window's first 4 launches over their device time, in % (layer: kernels)."""

from portbench.harness import launches


def install(records):
    return launches.camera_composites(records)


def read(trace):
    return launches.roofline_pct(trace, "k2", "camera_fwd_kernel")
