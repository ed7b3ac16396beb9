"""The trained model's share of the card's peak over the window, in %: the
FLOPs of each part of a training step (its family's `step_flops`, from the
configuration's widths) over that part's dtype's peak, summed over the
window's steps, over the window's length (layer: model)."""


def read(trace):
    peak = trace.context.get("peaks")
    steps = trace.count("train_step")
    if peak is None or not steps or trace.window_s <= 0:
        return None
    parts = trace.context["family"].step_flops(trace.context["config"], trace.records)
    seconds = sum(flops / peak[dtype] for flops, dtype in parts)
    return 100.0 * steps * seconds / trace.window_s
