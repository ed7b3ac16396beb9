"""Device idle milliseconds a training step while the host is in its
backward (`train.backward`: zeroing the gradients and autograd's pass), over
the window's `train_step` spans (layer: model)."""

from portbench.harness import spans


def read(trace):
    return spans.per(trace, spans.idle_inside(trace, ("train.backward",)), "train_step")
