"""Share of the serving window in which no operation ran on the device, in
% (layer: device)."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
