"""Device idle milliseconds a training step while the host is in its
forward (`train.forward`: the draws, the chunks' field renders and the
losses), over the window's `train_step` spans (layer: model)."""

from portbench.harness import spans


def read(trace):
    return spans.per(trace, spans.idle_inside(trace, ("train.forward",)), "train_step")
