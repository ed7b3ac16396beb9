"""Mean host milliseconds of the copy of a served image to the host
(`pipeline.to_host`: the device's last work on the request, then the copy)
(layer: pipelines)."""

from portbench.harness import spans


def read(trace):
    return spans.mean_length_ms(trace, "pipeline.to_host")
