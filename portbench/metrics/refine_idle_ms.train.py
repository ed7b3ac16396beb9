"""Device idle milliseconds a training step while the host is in the
densification (`train.refine`: the MCMC relocation and its noise), over the
window's `train_step` spans (layer: pipelines)."""

from portbench.harness import spans


def read(trace):
    return spans.per(trace, spans.idle_inside(trace, ("train.refine",)), "train_step")
