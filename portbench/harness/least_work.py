"""The least work of a kernel launch and the chip's published peaks.

A frozen copy of `chip_smoke.py`'s arithmetic (`_bound`, `_row_bytes`,
`_gate_counts`, the hash-grid lookup's byte and operation counts), computed
from a launch's own inputs with the reference's copy of the plain functions.
A roofline share is the least time over the measured device time: the least
time is the larger of the bytes over the memory bandwidth and the operations
over the fp32 rate outside the tensor cores. Each input byte is counted read
once and each output byte written once; where the work depends on the data
(a gated alpha, rows shared by lookups), what these inputs need is counted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), at its full 700 W
PEAKS = {
    "NVIDIA H100": {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12, "bytes": 3.35e12},
}


def peaks(device_name: str) -> Optional[dict]:
    """The peaks of the card named `device_name` (torch.cuda.get_device_name),
    None for a card the table does not hold."""
    for prefix, table in PEAKS.items():
        if device_name.startswith(prefix):
            return table
    return None


def least_seconds(bytes_moved: float, ops: float, peak: dict) -> Tuple[float, str]:
    """(the least time of a launch, what bounds it)."""
    t_bytes, t_ops = bytes_moved / peak["bytes"], ops / peak["fp32"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@torch.no_grad()
def hash_lookup(positions, stds, n_levels, scales, buckets, dense_res, f, cell_packed, from_copy) -> Tuple[int, int]:
    """(bytes, operations) of one multi-level hash-grid lookup (K1f):
    positions, stds and output once, each distinct table row the positions
    touch once, in the bytes of the type read (bf16 copies: 2)."""
    from portbench.reference.port.ops.hash_encoding import level_index

    n, d = positions.shape
    touched = sum(int(torch.unique(level_index(positions, s, b, r, cell_packed)[0]).numel())
                  for s, b, r in zip(scales, buckets, dense_res))
    row_values = (2 ** d if cell_packed else 1) * f
    n_std = 0 if stds is None else stds.numel()
    bytes_moved = touched * row_values * (2 if from_copy else 4) + (positions.numel() + n_std + n * n_levels * f) * 4
    ops = n * n_levels * ((2 ** d) * (d + 2 * f) + 6 * d + 8)
    return bytes_moved, ops


@torch.no_grad()
def hash_lookup_bwd(positions, stds, n_levels, scales, buckets, dense_res, f, cell_packed, g_numel) -> Tuple[int, int]:
    """(bytes, operations) of one hash-grid lookup's backward (K1b): the
    positions and stds read and their gradients written, the output gradient
    read, each distinct row the positions touch read (for the position
    gradient) and written (the table gradient's rows; the zero-fill of the
    rest of the dense gradient is an operation of its own)."""
    from portbench.reference.port.ops.hash_encoding import level_index

    n, d = positions.shape
    corners = 2 ** d
    row_bytes = (corners if cell_packed else 1) * f * 4
    touched = sum(int(torch.unique(level_index(positions, s, b, r, cell_packed)[0]).numel())
                  for s, b, r in zip(scales, buckets, dense_res))
    n_std = 0 if stds is None else stds.numel()
    bytes_moved = 2 * (positions.numel() + n_std) * 4 + g_numel * 4 + 2 * touched * row_bytes
    ops = n * n_levels * (corners * (2 * d + 4 * f) + 2 * d * corners + 20)
    return bytes_moved, ops


@torch.no_grad()
def camera_composite(table, tile_gauss, tile_valid, pix, times, tile_chunk: int = 128) -> Tuple[int, int]:
    """(bytes, operations) of one camera tile composite (K2). Operations: a
    valid (pixel, slot) pair beyond the far cut (sigma_raw > 5.6 of a slot of
    opacity at most 1) its quadratic form and the comparison (16), any other
    valid pair its gated alpha (32), and a pair whose alpha passes the gate
    the feature, depth and alpha sums and the transmittance (2 (C + 2))."""
    from portbench.reference.port.ops import tile_composite as TC

    t_total, p, c = tile_gauss.shape[0], pix.shape[1], table.shape[1] - TC.ATTR
    nonzero = far_pairs = 0
    for s in range(0, t_total, tile_chunk):
        e = min(t_total, s + tile_chunk)
        valid = tile_valid[s:e] > 0
        g = TC._gather(table, tile_gauss[s:e])
        terms = TC._alpha_terms(g, valid, pix[s:e, :, 0:1], pix[s:e, :, 1:2], times[s:e], False)
        sigma_raw, alpha = terms[2], terms[5]
        nonzero += int((alpha > 0).sum())
        far_pairs += int(((sigma_raw > 5.6) & (valid & (g[..., 7] <= 1.0))[:, None, :]).sum())
    pairs = int((tile_valid > 0).sum()) * p
    ops = far_pairs * 16 + (pairs - far_pairs) * 32 + nonzero * 2 * (c + 2)
    used = torch.unique(tile_gauss[tile_valid > 0])
    bytes_moved = ((tile_gauss.numel() + tile_valid.numel() + pix.numel() + times.numel()) * 4
                   + used.numel() * table.shape[1] * 4 + t_total * p * (c + 2) * 4)
    return bytes_moved, ops
