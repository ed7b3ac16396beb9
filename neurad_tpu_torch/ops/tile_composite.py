"""Per-tile gaussian compositing: the two forward tile composites of the
serving path, as hand-written CUDA kernels (`csrc/tile_composite.cu`) with a
plain PyTorch version of each beside them.

  tile_composite_camera  <- neurad_tpu/ops/pallas_composite.py `_composite_fwd_kernel` (K2)
  tile_composite_lidar   <- neurad_tpu/ops/pallas_composite.py `_make_lidar_fwd_kernel` (K4)

Both read a per-gaussian packed table [N, 10 + C] (`PACKED_COLUMNS` then C
features) through the per-tile index lists `tile_gauss` [T, K] (int32, front
to back) with slot validity `tile_valid` [T, K]; the TPU kernels take the same
rows pre-gathered into [T, K, ...] arrays. Index entries are clamped into
[0, N). Everything is fp32.

Dispatch is by device: tensors on the CPU go to the plain version, tensors on
a CUDA device to the kernel; anything else raises. Each wrapper counts its
kernel launches in `camera_launches` / `lidar_launches`.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from neurad_tpu_torch.ops import _build

PACKED_COLUMNS = ("mean_x", "mean_y", "vel_x", "vel_y", "conic_a", "conic_b", "conic_c", "opacity", "depth", "depth_vel")
ATTR = len(PACKED_COLUMNS)
MAX_FEATURES = 32
MAX_SLOTS_PER_TILE = 1024

camera_launches = 0
lidar_launches = 0


def reset_launch_counts() -> None:
    global camera_launches, lidar_launches
    camera_launches = 0
    lidar_launches = 0


# ---------------------------------------------------------------------------
# plain versions (chunked over tiles: an unchunked full-width [T, P, K] tensor
# is 2.1 GB apiece)
# ---------------------------------------------------------------------------


def floored_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """x mod m (m > 0) with the sign of m, computed as jnp.mod does: the exact
    fmod, plus m where it is negative. torch.remainder rounds differently
    (it gives 360.0 for 359.99997 mod 360), torch.fmod keeps the sign of x."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def _gather(table: torch.Tensor, tile_gauss: torch.Tensor) -> torch.Tensor:
    return table[tile_gauss.long().clamp(0, table.shape[0] - 1)]  # [t, K, 10 + C]


def _alpha(g, valid, x, y, t, wrap: bool):
    """[t, P, K] alpha with the TPU kernels' clipping and gating, and the
    rolling-shutter-corrected depth of every slot. g [t, K, 10 + C];
    valid [t, K] bool; x, y, t [t, P, 1]."""
    dx = x - (g[:, None, :, 0] + g[:, None, :, 2] * t)
    if wrap:
        dx = floored_mod(dx + 180.0, 360.0) - 180.0
    dy = y - (g[:, None, :, 1] + g[:, None, :, 3] * t)
    sigma = 0.5 * (g[:, None, :, 4] * dx * dx + g[:, None, :, 6] * dy * dy) + g[:, None, :, 5] * dx * dy
    alpha = (g[:, None, :, 7] * torch.exp(-sigma.clamp(0.0, 50.0))).clamp(0.0, 0.999)
    alpha = torch.where(valid[:, None, :] & (alpha >= 1.0 / 255.0), alpha, torch.zeros_like(alpha))
    g_depth = g[:, None, :, 8] + g[:, None, :, 9] * t
    return alpha, g_depth


def _weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_k = alpha_k * prod_{j<k} (1 - alpha_j) along the last axis."""
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return alpha * trans


def tile_composite_camera_plain(table, tile_gauss, tile_valid, pix, times, tile_chunk: int = 128):
    """K2's function in plain PyTorch. pix [T, P, 2], times [T, P, 1] ->
    (feat [T, P, C], depth [T, P, 1], alpha [T, P, 1])."""
    t_total, p = pix.shape[:2]
    c = table.shape[1] - ATTR
    feat = table.new_empty((t_total, p, c))
    depth = table.new_empty((t_total, p, 1))
    acc = table.new_empty((t_total, p, 1))
    for s in range(0, t_total, tile_chunk):
        e = min(t_total, s + tile_chunk)
        g = _gather(table, tile_gauss[s:e])
        alpha, g_depth = _alpha(g, tile_valid[s:e] > 0, pix[s:e, :, 0:1], pix[s:e, :, 1:2], times[s:e], False)
        w = _weights(alpha)
        feat[s:e] = torch.einsum("tpk,tkc->tpc", w, g[..., ATTR:])
        depth[s:e] = torch.sum(w * g_depth, dim=-1, keepdim=True)
        acc[s:e] = torch.sum(w, dim=-1, keepdim=True)
    return feat, depth, acc


def _lidar_plain_chunks(
    table, tile_gauss, tile_valid, pts_slot, vmask, wrap, tile_chunk
) -> Iterator[Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(start, end, g, w [t, P, K], g_depth [t, P, K]) per chunk of tiles."""
    t_total = pts_slot.shape[0]
    for s in range(0, t_total, tile_chunk):
        e = min(t_total, s + tile_chunk)
        g = _gather(table, tile_gauss[s:e])
        pts = pts_slot[s:e]
        alpha, g_depth = _alpha(g, tile_valid[s:e] > 0, pts[..., 0:1], pts[..., 1:2], pts[..., 3:4], wrap)
        alpha = torch.where(vmask[s:e, :, None] > 0, alpha, torch.zeros_like(alpha))
        yield s, e, g, _weights(alpha), g_depth


def median_index(w: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Index of the first slot whose inclusive weight sum reaches half the
    total `acc` [..., 1] (slot 0 where the total is 0)."""
    crossed = torch.cumsum(w, dim=-1) >= 0.5 * acc
    return crossed.to(torch.uint8).argmax(dim=-1, keepdim=True)


def tile_composite_lidar_plain(
    table, tile_gauss, tile_valid, pts_slot, vmask, wrap: bool, depth_eps: float, compute_until: bool,
    tile_chunk: int = 128,
):
    """K4's function in plain PyTorch. pts_slot [T, P, 4] (azimuth, elevation,
    gt depth, time), vmask [T, P] -> (feat [T, P, C], depth, acc, until, median
    [T, P, 1]). The median is the depth of the first slot whose inclusive
    weight sum reaches half the total, slot 0's where the total is 0."""
    t_total, p = pts_slot.shape[:2]
    c = table.shape[1] - ATTR
    feat = table.new_empty((t_total, p, c))
    depth, acc, until, med = (table.new_empty((t_total, p, 1)) for _ in range(4))
    for s, e, g, w, g_depth in _lidar_plain_chunks(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, tile_chunk):
        feat[s:e] = torch.einsum("tpk,tkc->tpc", w, g[..., ATTR:])
        depth[s:e] = torch.sum(w * g_depth, dim=-1, keepdim=True)
        acc[s:e] = torch.sum(w, dim=-1, keepdim=True)
        if compute_until:
            before = g_depth < (pts_slot[s:e, :, 2:3] - depth_eps)
            until[s:e] = torch.sum(torch.where(before, w, torch.zeros_like(w)), dim=-1, keepdim=True)
        else:
            until[s:e] = 0.0
        med[s:e] = torch.gather(g_depth, -1, median_index(w, acc[s:e]))
    return feat, depth, acc, until, med


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _device_of(*tensors) -> torch.device:
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"tile composite inputs lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tile composite runs on cpu or cuda tensors, got {dev}")
    return dev


def _check(table, tile_gauss, tile_valid, per_slot, per_slot_shapes):
    """Validate what the kernels take; returns (T, P, K, C)."""
    if table.dim() != 2 or not ATTR <= table.shape[1] <= ATTR + MAX_FEATURES:
        raise ValueError(f"table must be [N, {ATTR} + C] with C <= {MAX_FEATURES}, got {tuple(table.shape)}")
    if table.shape[0] == 0:
        raise ValueError("table is empty")
    if tile_gauss.dim() != 2 or tile_gauss.dtype != torch.int32:
        raise ValueError(f"tile_gauss must be int32 [T, K], got {tile_gauss.dtype} {tuple(tile_gauss.shape)}")
    t_total, k = tile_gauss.shape
    if tuple(tile_valid.shape) != (t_total, k):
        raise ValueError(f"tile_valid must be [T, K] = {(t_total, k)}, got {tuple(tile_valid.shape)}")
    p = per_slot[0].shape[1] if per_slot[0].dim() >= 2 else -1
    if not 0 < p <= MAX_SLOTS_PER_TILE:
        raise ValueError(f"slots per tile must be in [1, {MAX_SLOTS_PER_TILE}], got {p}")
    for x, tail in zip(per_slot, per_slot_shapes):
        if tuple(x.shape) != (t_total, p) + tail:
            raise ValueError(f"expected shape {(t_total, p) + tail}, got {tuple(x.shape)}")
    for x in (table, tile_valid) + tuple(per_slot):
        if x.dtype != torch.float32:
            raise ValueError(f"tile composite takes float32 tensors, got {x.dtype}")
    for x in (table, tile_gauss, tile_valid) + tuple(per_slot):
        if not x.is_contiguous():
            raise ValueError("tile composite takes contiguous tensors")
    return t_total, p, k, table.shape[1] - ATTR


def tile_composite_camera(table, tile_gauss, tile_valid, pix, times):
    """Camera per-tile composite (K2). table [N, 10 + C] f32, tile_gauss [T, K]
    int32, tile_valid [T, K] f32, pix [T, P, 2], times [T, P, 1] ->
    (feat [T, P, C], depth [T, P, 1], alpha [T, P, 1])."""
    global camera_launches
    dev = _device_of(table, tile_gauss, tile_valid, pix, times)
    t_total, p, k, c = _check(table, tile_gauss, tile_valid, (pix, times), ((2,), (1,)))
    if dev.type == "cpu":
        return tile_composite_camera_plain(table, tile_gauss, tile_valid, pix, times)
    feat = torch.empty((t_total, p, c), device=dev)
    depth = torch.empty((t_total, p, 1), device=dev)
    alpha = torch.empty((t_total, p, 1), device=dev)
    if t_total == 0:
        return feat, depth, alpha
    lib = _build.load("tile_composite")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tile_composite_camera_fwd(
            table.data_ptr(), table.shape[0], c, tile_gauss.data_ptr(), tile_valid.data_ptr(),
            pix.data_ptr(), times.data_ptr(), t_total, p, k,
            feat.data_ptr(), depth.data_ptr(), alpha.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_composite_camera_fwd launch failed: cudaError {rc}")
    camera_launches += 1
    return feat, depth, alpha


def tile_composite_lidar(table, tile_gauss, tile_valid, pts_slot, vmask, wrap: bool, depth_eps: float,
                         compute_until: bool):
    """Lidar per-tile composite (K4). pts_slot [T, P, 4] (azimuth, elevation,
    gt depth, time) f32, vmask [T, P] f32, the rest as the camera composite ->
    (feat [T, P, C], depth, acc, alpha_sum_until, median_depth [T, P, 1])."""
    global lidar_launches
    dev = _device_of(table, tile_gauss, tile_valid, pts_slot, vmask)
    t_total, p, k, c = _check(table, tile_gauss, tile_valid, (pts_slot, vmask), ((4,), ()))
    if dev.type == "cpu":
        return tile_composite_lidar_plain(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps,
                                          compute_until)
    feat = torch.empty((t_total, p, c), device=dev)
    depth, acc, until, med = (torch.empty((t_total, p, 1), device=dev) for _ in range(4))
    if t_total == 0:
        return feat, depth, acc, until, med
    lib = _build.load("tile_composite")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tile_composite_lidar_fwd(
            table.data_ptr(), table.shape[0], c, tile_gauss.data_ptr(), tile_valid.data_ptr(),
            pts_slot.data_ptr(), vmask.data_ptr(), t_total, p, k, int(wrap), float(depth_eps), int(compute_until),
            feat.data_ptr(), depth.data_ptr(), acc.data_ptr(), until.data_ptr(), med.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_composite_lidar_fwd launch failed: cudaError {rc}")
    lidar_launches += 1
    return feat, depth, acc, until, med
