"""Share of the gaussian slots that a refine relocates, in %: 100 x
`mcmc.relocated` / (`mcmc.refines` x the configuration's `cap_max`), the
port's counters over the window (None where the port counted no refine)
(layer: model)."""

from portbench.harness import spans


def install(records):
    return spans.counting(records)


def read(trace):
    counters = trace.records.get("counters") or {}
    cap = trace.context["config"].get("cap_max")
    refines = counters.get("mcmc.refines")
    if not refines or not cap:
        return None
    return 100.0 * counters.get("mcmc.relocated", 0) / (refines * cap)
