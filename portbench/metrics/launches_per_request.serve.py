"""Device kernels a camera request launches: every kernel the profiler saw
in the window, over the window's `render_image` spans (layer: model)."""


def read(trace):
    requests = trace.count("render_image")
    return len(trace.kernels) / requests if requests else None
