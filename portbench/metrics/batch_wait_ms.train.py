"""Mean host milliseconds a training step waits in `next(batches)` for the
datamanager's sampler threads (layer: trainer and datamanager)."""


def read(trace):
    waits = [end - start for name, start, end in trace.spans if name == "next(batches)"]
    return 1e3 * sum(waits) / len(waits) if waits else None
