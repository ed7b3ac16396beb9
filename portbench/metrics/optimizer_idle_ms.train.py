"""Device idle milliseconds a training step while the host is in the
optimizers' step (`train.optimizer`, torch's `Optimizer.step` annotations
inside it), over the window's `train_step` spans (layer: pipelines)."""

from portbench.harness import spans


def read(trace):
    return spans.per(trace, spans.idle_inside(trace, ("train.optimizer",)), "train_step")
