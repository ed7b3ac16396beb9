"""The least work of the SplatAD training kernels K3, K4 and K5 (the camera
composite's backward, the lidar composite and its backward), and their
launch recorders.

A frozen copy of `chip_smoke.py`'s arithmetic for K4 and K5 (`_lidar_counts`,
`_row_bytes`, the least work of the lidar forward and backward), with K3
counted as K5 is: computed from a launch's own inputs with the reference's
copy of the plain functions, and set beside its device time by
`launches.roofline_pct`. Operations: a valid (query, slot) pair beyond the
far cut (sigma_raw > 5.6 of a slot of opacity at most 1) its quadratic form
(16, the lidar's 20 with the azimuth's wrap), any other valid pair its gated
alpha (32, 36), and a pair whose alpha passes the gate its share of the sums:
the forward's feature, depth, alpha, line-of-sight and running sums and the
transmittance (2 (C + 2) + 3), the backward's payload gradient (2 C + 4, the
lidar's 2 C + 6), gradient terms (45 + C) and the sum over the tile's queries
of the 10 + C terms. Bytes: each input read once (the index lists and
validity, the queries, the rows the valid slots use), each output written
once; a backward reads the forward's outputs and the cotangents of each query
and writes the rows of the table's gradient that its valid slots use (the
zero-fill of the rest is a kernel of its own, where `chip_smoke.py` counts the
whole table).

A recorder keeps the inputs of the window's first `FIRST` launches of its
kernel (`ops.tile_composite._camera_backward`, `_lidar_forward`,
`_lidar_backward`); a reader fills `records[key]["counts"]` from them with
`counted` before it calls `launches.roofline_pct`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from portbench.harness import launches

FIRST = 2  # launches recorded a kernel: a 5,000,000-gaussian table is 520 MB a copy
MODULE = "neurad_tpu_torch.ops.tile_composite"


def _row_bytes(table, tile_gauss, tile_valid) -> int:
    """Bytes of the table rows the valid slots reference (each read once)."""
    used = torch.unique(tile_gauss[tile_valid > 0])
    return used.numel() * table.shape[1] * 4


@torch.no_grad()
def _camera_counts(table, tile_gauss, tile_valid, pix, times, tile_chunk: int = 128) -> dict:
    """Over the camera composite's valid (pixel, slot) pairs: all of them,
    those whose gated alpha is positive and those beyond the far cut."""
    from portbench.reference.port.ops import tile_composite as TC

    n = dict(pairs=int((tile_valid > 0).sum()) * pix.shape[1], lit_pairs=0, far_pairs=0)
    for s in range(0, tile_gauss.shape[0], tile_chunk):
        e = min(tile_gauss.shape[0], s + tile_chunk)
        valid = tile_valid[s:e] > 0
        g = TC._gather(table, tile_gauss[s:e])
        terms = TC._alpha_terms(g, valid, pix[s:e, :, 0:1], pix[s:e, :, 1:2], times[s:e], False)
        n["lit_pairs"] += int((terms[5] > 0).sum())
        n["far_pairs"] += int(((terms[2] > 5.6) & (valid & (g[..., 7] <= 1.0))[:, None, :]).sum())
    return n


@torch.no_grad()
def _lidar_counts(table, tile_gauss, tile_valid, pts_slot, vmask, tile_chunk: int = 128) -> dict:
    """Over the lidar composite's valid (query, slot) pairs (valid query
    slot, valid gaussian slot): all of them, those whose gated alpha is
    positive and those beyond the far cut; and the valid query slots."""
    from portbench.reference.port.ops import tile_composite as TC

    n = dict(queries=int((vmask > 0).sum()), pairs=0, lit_pairs=0, far_pairs=0)
    for s in range(0, pts_slot.shape[0], tile_chunk):
        e = min(pts_slot.shape[0], s + tile_chunk)
        valid, on = tile_valid[s:e] > 0, vmask[s:e] > 0
        g = TC._gather(table, tile_gauss[s:e])
        pts = pts_slot[s:e]
        terms = TC._alpha_terms(g, valid, pts[..., 0:1], pts[..., 1:2], pts[..., 3:4], True)
        pair = valid[:, None, :] & on[:, :, None]
        n["pairs"] += int(pair.sum())
        n["lit_pairs"] += int(((terms[5] > 0) & pair).sum())
        n["far_pairs"] += int(((terms[2] > 5.6) & (g[..., 7] <= 1.0)[:, None, :] & pair).sum())
    return n


def camera_backward(table, tile_gauss, tile_valid, pix, times) -> Tuple[int, int]:
    """(bytes, operations) of one camera composite backward (K3)."""
    t_total, p, c = tile_gauss.shape[0], pix.shape[1], table.shape[1] - 10
    n = _camera_counts(table, tile_gauss, tile_valid, pix, times)
    far, lit = n["far_pairs"], n["lit_pairs"]
    ops = far * 16 + (n["pairs"] - far) * 32 + lit * ((2 * c + 4) + 45 + c + table.shape[1])
    rows = _row_bytes(table, tile_gauss, tile_valid)
    bytes_moved = ((tile_gauss.numel() + tile_valid.numel() + pix.numel() + times.numel()) * 4
                   + 2 * t_total * p * (c + 2) * 4  # the forward's outputs and their cotangents
                   + 2 * rows)  # the rows read, and their gradient written
    return bytes_moved, ops


def lidar_forward(table, tile_gauss, tile_valid, pts_slot, vmask) -> Tuple[int, int]:
    """(bytes, operations) of one lidar composite (K4)."""
    t_total, p, c = tile_gauss.shape[0], pts_slot.shape[1], table.shape[1] - 10
    n = _lidar_counts(table, tile_gauss, tile_valid, pts_slot, vmask)
    far, lit = n["far_pairs"], n["lit_pairs"]
    ops = far * 20 + (n["pairs"] - far) * 36 + lit * (2 * (c + 2) + 3)
    list_bytes = tile_gauss.numel() * 4 + tile_valid.numel() * 4 + vmask.numel() * 4
    bytes_moved = (list_bytes + vmask.numel() * 4 + n["queries"] * 12  # every query slot's time, the rest valid ones'
                   + _row_bytes(table, tile_gauss, tile_valid) + t_total * p * (c + 4) * 4)
    return bytes_moved, ops


def lidar_backward(table, tile_gauss, tile_valid, pts_slot, vmask) -> Tuple[int, int]:
    """(bytes, operations) of one lidar composite backward (K5)."""
    c = table.shape[1] - 10
    n = _lidar_counts(table, tile_gauss, tile_valid, pts_slot, vmask)
    far, lit = n["far_pairs"], n["lit_pairs"]
    ops = far * 20 + (n["pairs"] - far) * 36 + lit * ((2 * c + 6) + 45 + c + table.shape[1])
    list_bytes = tile_gauss.numel() * 4 + tile_valid.numel() * 4 + vmask.numel() * 4
    bytes_moved = list_bytes + n["queries"] * (16 + 2 * (c + 3) * 4) + 2 * _row_bytes(table, tile_gauss, tile_valid)
    return bytes_moved, ops


COUNT = {"k3": camera_backward, "k4": lidar_forward, "k5": lidar_backward}


def _keep_inputs(table, tile_gauss, tile_valid, per_slot, vmask_or_times, *rest):
    """The launch's table, index lists and queries, copied (on a card only)."""
    if table.device.type != "cuda" or tile_gauss.shape[0] == 0:
        return None
    return dict(args=tuple(x.detach().clone() for x in (table, tile_gauss, tile_valid, per_slot, vmask_or_times)))


def camera_backwards(records: dict):
    """Records the first K3 launches (`ops.tile_composite._camera_backward`),
    one a camera step."""
    return launches._wrapped(records, "k3", MODULE, "_camera_backward", _keep_inputs, FIRST)


def lidar_forwards(records: dict):
    """Records the first K4 launches (`ops.tile_composite._lidar_forward`), one a lidar step."""
    return launches._wrapped(records, "k4", MODULE, "_lidar_forward", _keep_inputs, FIRST)


def lidar_backwards(records: dict):
    """Records the first K5 launches (`ops.tile_composite._lidar_backward`), one a lidar step."""
    return launches._wrapped(records, "k5", MODULE, "_lidar_backward", _keep_inputs, FIRST)


def counted(records: dict, key: str) -> Optional[List[tuple]]:
    """[(bytes, operations)] of each recorded launch of `key` ("k3", "k4",
    "k5"), counted once into records[key]["counts"]."""
    rec = records.get(key)
    if not rec or not rec["launches"]:
        return None
    if "counts" not in rec:
        rec["counts"] = [COUNT[key](*r["args"]) for r in rec["launches"]]
        rec["launches"] = [None] * len(rec["launches"])  # the inputs are no longer needed
    return rec["counts"]
