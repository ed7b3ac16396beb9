"""Device kernels a training step launches: every kernel the profiler saw in
the window, over the window's `train_step` spans (layer: model)."""


def read(trace):
    steps = trace.count("train_step")
    return len(trace.kernels) / steps if steps else None
