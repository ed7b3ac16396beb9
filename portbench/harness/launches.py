"""Launch recorders of the traced run: wrappers around the port's kernel
entries that keep the inputs of a window's first launches, so that a reader
can count their least work (`least_work.py`) and set it beside the device
time the profiler measured for the same launches.

A recorder is entered once however many readers ask for it; the k-th
recorded launch is the k-th kernel of its name in the trace. Where the port
no longer has the entry, entering the recorder raises: the traced run fails
rather than report a roofline it cannot count.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import List, Optional

from portbench.harness import least_work


@contextlib.contextmanager
def _wrapped(records: dict, key: str, module_name: str, attr: str, keep, first: int):
    if key in records:  # another reader entered this recorder
        yield
        return
    module = importlib.import_module(module_name)
    original = getattr(module, attr, None)
    if original is None:
        raise RuntimeError(f"the launch recorder {key!r} wraps {module_name}.{attr}, which the port no longer has")
    kept: List[dict] = []
    records[key] = {"launches": kept}

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        if len(kept) < first:
            item = keep(*args, **kwargs)
            if item is not None:
                kept.append(item)
        return out

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, original)


def _keep_lookup(positions, stds, tables, scales, buckets, dense_res, f, read_bf16, cell_packed, copies=None):
    if positions.device.type != "cuda" or positions.shape[0] == 0:
        return None
    return dict(positions=positions.detach().clone(), stds=None if stds is None else stds.detach().clone(),
                n_levels=len(tables), scales=list(scales), buckets=list(buckets), dense_res=list(dense_res), f=f,
                cell_packed=cell_packed, from_copy=copies is not None and read_bf16)


def hash_lookups(records: dict):
    """Records the first 16 K1f launches (`ops.hash_encoding._forward`): a
    NeuRAD request's, 8 chunks of a static and an actor lookup."""
    return _wrapped(records, "k1f", "neurad_tpu_torch.ops.hash_encoding", "_forward", _keep_lookup, 16)


def _keep_lookup_bwd(positions, stds, tables, scales, buckets, dense_res, f, read_bf16, cell_packed, g, *args,
                     **kwargs):
    if positions.device.type != "cuda" or positions.shape[0] == 0:
        return None
    return dict(positions=positions.detach().clone(), stds=None if stds is None else stds.detach().clone(),
                n_levels=len(tables), scales=list(scales), buckets=list(buckets), dense_res=list(dense_res), f=f,
                cell_packed=cell_packed, g_numel=g.numel())


def hash_lookup_backwards(records: dict):
    """Records the first 14 K1b launches (`ops.hash_encoding.hash_grid_encode_bwd`):
    a NeuRAD train step's, 7 chunks of a static and an actor lookup."""
    return _wrapped(records, "k1b", "neurad_tpu_torch.ops.hash_encoding", "hash_grid_encode_bwd", _keep_lookup_bwd,
                    14)


def _keep_composite(table, tile_gauss, tile_valid, pix, times):
    if table.device.type != "cuda" or tile_gauss.shape[0] == 0:
        return None
    return dict(args=tuple(x.detach().clone() for x in (table, tile_gauss, tile_valid, pix, times)))


def camera_composites(records: dict):
    """Records the first 4 K2 launches (`ops.tile_composite._camera_forward`),
    one a SplatAD request."""
    return _wrapped(records, "k2", "neurad_tpu_torch.ops.tile_composite", "_camera_forward", _keep_composite, 4)


def counted(records: dict, key: str) -> Optional[List[tuple]]:
    """[(bytes, operations)] of each recorded launch of `key`, counted once."""
    rec = records.get(key)
    if not rec or not rec["launches"]:
        return None
    if "counts" not in rec:
        if key == "k1f":
            rec["counts"] = [least_work.hash_lookup(r["positions"], r["stds"], r["n_levels"], r["scales"],
                                                    r["buckets"], r["dense_res"], r["f"], r["cell_packed"],
                                                    r["from_copy"]) for r in rec["launches"]]
        elif key == "k1b":
            rec["counts"] = [least_work.hash_lookup_bwd(r["positions"], r["stds"], r["n_levels"], r["scales"],
                                                        r["buckets"], r["dense_res"], r["f"], r["cell_packed"],
                                                        r["g_numel"]) for r in rec["launches"]]
        else:
            rec["counts"] = [least_work.camera_composite(*r["args"]) for r in rec["launches"]]
        rec["launches"] = [None] * len(rec["launches"])  # the inputs are no longer needed
    return rec["counts"]


def roofline_pct(trace, key: str, kernel: str) -> Optional[float]:
    """The recorded launches' least time over their device time, in %."""
    counts = counted(trace.records, key)
    peak = trace.context.get("peaks")
    launches = trace.kernels_named(kernel)
    if launches and not counts:
        raise RuntimeError(f"the trace holds {len(launches)} launches of {kernel} and the recorder {key!r} none")
    if counts and len(launches) < len(counts):
        raise RuntimeError(f"{len(counts)} launches recorded by {key!r}, {len(launches)} kernels named {kernel} traced")
    if not counts or peak is None:
        return None
    least = sum(least_work.least_seconds(b, o, peak)[0] for b, o in counts)
    device = sum(d for _, _, d in launches[: len(counts)])
    return 100.0 * least / device if device > 0 else None
