"""Device idle milliseconds a camera request while the host is in the
model: the pipeline's chunks (`pipeline.chunk`) and the model's parts
(`model.*`), over the window's `render_image` spans (layer: model)."""

from portbench.harness import spans


def read(trace):
    return spans.per(trace, spans.idle_inside(trace, ("pipeline.chunk", "model.*")), "render_image")
