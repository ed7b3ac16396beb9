"""The served model's share of the card's peak over the window, in %: the
FLOPs of each part of a camera request (its family's `request_flops`, from
the configuration's widths) over that part's dtype's peak, summed over the
window's requests, over the window's length (layer: model)."""

from portbench.harness import launches


def install(records):
    return launches.camera_composites(records)  # SplatAD counts its composite's operations from the launches


def read(trace):
    peak = trace.context.get("peaks")
    requests = trace.count("render_image")
    if peak is None or not requests or trace.window_s <= 0:
        return None
    launches.counted(trace.records, "k2")
    parts = trace.context["family"].request_flops(trace.context["config"], trace.records)
    seconds = sum(flops / peak[dtype] for flops, dtype in parts)
    return 100.0 * requests * seconds / trace.window_s
