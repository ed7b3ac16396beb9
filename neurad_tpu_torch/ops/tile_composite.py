"""Per-tile gaussian compositing: the forward tile composites and their fused
backwards, as hand-written CUDA kernels (`csrc/tile_composite.cu`,
`csrc/tile_composite_bwd.cu`) with a plain PyTorch version of each beside them.

  tile_composite_camera  forward  <- neurad_tpu/ops/pallas_composite.py `_composite_fwd_kernel` (K2)
                         backward <- `_composite_bwd_kernel` (K3)
  tile_composite_lidar   forward  <- `_make_lidar_fwd_kernel` (K4)
                         backward <- `_make_lidar_bwd_kernel` (K5)

Both read a per-gaussian packed table [N, 10 + C] (`PACKED_COLUMNS` then C
features) through the per-tile index lists `tile_gauss` [T, K] (int32, front
to back) with slot validity `tile_valid` [T, K]; the TPU kernels take the same
rows pre-gathered into [T, K, ...] arrays. Index entries are clamped into
[0, N). Everything is fp32.

The backward kernels replace the TPU kernels' per-tile `[T, K, 10]` and
`[T, K, C]` gradients and the scatter-add that follows them in the JAX
package: they add straight into the gradient of the packed table
`d_table [N, 10 + C]`. Only the table gets a gradient; pixel coordinates,
times, query points, masks and the lidar's median depth get none. An invalid
slot adds nothing, and neither does an index entry that had to be clamped.
What bounds the kernels on the card and what their design does about it is
written in the two `.cu` sources.

`tile_composite_camera` / `tile_composite_lidar` go through the
`TileCompositeCamera` / `TileCompositeLidar` autograd functions, so rendering
and training share one path. Both save their outputs too: the backward takes
the total G = sum_k w_k g_k from them (`payload_total`). The lidar forward
always computes the line-of-sight sum for that (its cotangent enters the
gradient, as in JAX, whether or not the caller asked for the sum) and hands
the caller zeros where it did not ask. Dispatch is by device: tensors on the CPU go to
the plain versions (forward and backward), tensors on a CUDA device to the
kernels; anything else raises. Each launch is counted in `camera_launches` /
`lidar_launches` / `camera_bwd_launches` / `lidar_bwd_launches`.

The kernels' atomics add fp32 terms in an order that changes from run to run,
so two backward launches on the same inputs agree to rounding, not bitwise.
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
camera_bwd_launches = 0
lidar_bwd_launches = 0


def reset_launch_counts() -> None:
    global camera_launches, lidar_launches, camera_bwd_launches, lidar_bwd_launches
    camera_launches = 0
    lidar_launches = 0
    camera_bwd_launches = 0
    lidar_bwd_launches = 0


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


def _alpha_terms(g, valid, x, y, t, wrap: bool):
    """Everything a (pixel, slot) pair evaluates on the way to its alpha, each
    [t, P, K]: (dx, dy, sigma_raw, exp(-clipped sigma), alpha_pre, alpha) and
    the rolling-shutter-corrected depth of every slot. g [t, K, 10 + C];
    valid [t, K] bool or [t, P, K] bool; x, y, t [t, P, 1]."""
    dx = x - (g[:, None, :, 0] + g[:, None, :, 2] * t)
    if wrap:
        dx = floored_mod(dx + 180.0, 360.0) - 180.0
    dy = y - (g[:, None, :, 1] + g[:, None, :, 3] * t)
    sigma_raw = 0.5 * (g[:, None, :, 4] * dx * dx + g[:, None, :, 6] * dy * dy) + g[:, None, :, 5] * dx * dy
    exp_neg = torch.exp(-sigma_raw.clamp(0.0, 50.0))
    alpha_pre = g[:, None, :, 7] * exp_neg
    alpha = alpha_pre.clamp(0.0, 0.999)
    if valid.dim() == 2:
        valid = valid[:, None, :]
    alpha = torch.where(valid & (alpha >= 1.0 / 255.0), alpha, torch.zeros_like(alpha))
    g_depth = g[:, None, :, 8] + g[:, None, :, 9] * t
    return dx, dy, sigma_raw, exp_neg, alpha_pre, alpha, g_depth


def _alpha(g, valid, x, y, t, wrap: bool):
    """[t, P, K] alpha with the TPU kernels' clipping and gating, and the
    rolling-shutter-corrected depth of every slot."""
    terms = _alpha_terms(g, valid, x, y, t, wrap)
    return terms[5], terms[6]


def _exclusive_cumprod(one_minus: torch.Tensor) -> torch.Tensor:
    trans = torch.cumprod(one_minus, dim=-1)
    return torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)


def _weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_k = alpha_k * prod_{j<k} (1 - alpha_j) along the last axis."""
    return alpha * _exclusive_cumprod(1.0 - alpha)


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


def _bwd_chunk(d_table, table, tile_gauss, tile_valid, x, y, t, wrap, vmask, before_depth, g_feat, g_depth, g_alpha,
               g_until, magnitude=False, total=None):
    """The fused backward's formula for a chunk of tiles, added into d_table.
    x, y, t, g_depth, g_alpha [t, P, 1]; g_feat [t, P, C]; vmask [t, P] bool or
    None; before_depth, g_until [t, P, 1] or None (camera); total [t, P, 1]
    or None: G = sum_k w_k g_k given (from the forward's outputs) instead of
    summed here. With `magnitude` every sum (over features, slots and pixels)
    adds the absolute values of its terms and the suffix sum G - P_k is
    replaced by the sum over all slots."""
    g = _gather(table, tile_gauss)
    valid = tile_valid > 0
    pair_valid = valid[:, None, :] if vmask is None else valid[:, None, :] & vmask[:, :, None]
    dx, dy, sigma_raw, exp_neg, alpha_pre, alpha, depth = _alpha_terms(g, pair_valid, x, y, t, wrap)
    # the clips are flat outside their ranges, the gate where alpha is zeroed
    dgate = (alpha > 0) & (alpha_pre < 0.999) & (sigma_raw > 0.0) & (sigma_raw < 50.0)
    trans = _exclusive_cumprod(1.0 - alpha)
    w = alpha * trans
    mag = torch.abs if magnitude else (lambda v: v)
    payload = (torch.einsum("tpc,tkc->tpk", mag(g_feat), mag(g[..., ATTR:])) + mag(depth) * mag(g_depth)
               + mag(g_alpha))
    if g_until is not None:
        payload = payload + (depth < before_depth).to(payload.dtype) * mag(g_until)
    prefix = torch.cumsum(w * payload, dim=-1)  # inclusive
    if total is None:
        total = prefix[..., -1:]
    if magnitude:  # G and P_k are both sums of the w * payload terms: of every slot's between them
        d_alpha = (trans * payload + prefix[..., -1:] / (1.0 - alpha)) * dgate
    else:
        d_alpha = (trans * payload - (total - prefix) / (1.0 - alpha)) * dgate
    d_sigma = -alpha * d_alpha
    con_a, con_b, con_c = g[:, None, :, 4], g[:, None, :, 5], g[:, None, :, 6]
    ddx = d_sigma * (mag(con_a * dx) + mag(con_b * dy))
    ddy = d_sigma * (mag(con_c * dy) + mag(con_b * dx))
    w_gd = w * mag(g_depth)
    cols = [-ddx, -ddy, -ddx * t, -ddy * t, 0.5 * dx * dx * d_sigma, dx * dy * d_sigma, 0.5 * dy * dy * d_sigma,
            d_alpha * exp_neg, w_gd, w_gd * t]
    d_attr = torch.stack([mag(col).sum(dim=1) for col in cols], dim=-1)  # [t, K, 10]
    d_feat = torch.einsum("tpk,tpc->tkc", w, mag(g_feat))
    d_slots = torch.cat([d_attr, d_feat], dim=-1)
    idx = tile_gauss.long()
    keep = valid & (idx >= 0) & (idx < table.shape[0])
    d_table.index_add_(0, idx[keep], d_slots[keep])


def payload_total(feat, depth, alpha, g_feat, g_depth, g_alpha, until=None, g_until=None):
    """G = sum_k w_k g_k per pixel from a composite's outputs, which are the
    raw sums feat = sum_k w_k f_k, depth = sum_k w_k d_k, alpha = sum_k w_k
    and, for the lidar, until = sum_k w_k [d_k < gt - eps]: <g_feat, feat> +
    g_depth depth + g_alpha alpha (+ g_until until) [..., 1] (K3 and K5 form
    the same sum per query in fp32)."""
    total = g_alpha * alpha + g_depth * depth + torch.sum(g_feat * feat, dim=-1, keepdim=True)
    return total if until is None else total + g_until * until


def tile_composite_camera_bwd_plain(table, tile_gauss, tile_valid, pix, times, g_feat, g_depth, g_alpha,
                                    tile_chunk: int = 128, magnitude: bool = False, outputs=None):
    """K3's function in plain PyTorch: the gradient of the packed table
    [N, 10 + C] for cotangents g_feat [T, P, C], g_depth, g_alpha [T, P, 1] of
    `tile_composite_camera_plain`'s outputs. `outputs`: those outputs (feat,
    depth, alpha) on the same inputs, from which G = sum_k w_k g_k is taken as
    K3 takes it (`payload_total`); without them G is the sum over the slots.
    With `magnitude` every sum in the formula adds the absolute values of its
    terms instead (G - P_k, which the division by 1 - a_k >= 0.001 amplifies,
    becomes the sum over all slots): the scale of an entry's fp32 rounding
    error, whatever cancels in the entry itself. A comparison of two
    implementations measures their difference by it."""
    d_table = torch.zeros_like(table)
    for s in range(0, pix.shape[0], tile_chunk):
        e = min(pix.shape[0], s + tile_chunk)
        total = None
        if outputs is not None:
            total = payload_total(*(x[s:e] for x in outputs), g_feat[s:e], g_depth[s:e], g_alpha[s:e])
        _bwd_chunk(d_table, table, tile_gauss[s:e], tile_valid[s:e], pix[s:e, :, 0:1], pix[s:e, :, 1:2], times[s:e],
                   False, None, None, g_feat[s:e], g_depth[s:e], g_alpha[s:e], None, magnitude, total)
    return d_table


def tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, wrap: bool, depth_eps: float,
                                   g_feat, g_depth, g_alpha, g_until, tile_chunk: int = 128,
                                   magnitude: bool = False, outputs=None):
    """K5's function in plain PyTorch: as the camera's (`magnitude` and
    `outputs` too), with the azimuth wrap, masked query slots and the
    cotangent g_until [T, P, 1] of the line-of-sight sum folded into the
    payload gradient. `outputs`: `tile_composite_lidar_plain`'s feat, depth,
    acc and until on the same inputs, the line-of-sight sum computed (as K5
    takes them). The median gets no gradient."""
    d_table = torch.zeros_like(table)
    for s in range(0, pts_slot.shape[0], tile_chunk):
        e = min(pts_slot.shape[0], s + tile_chunk)
        pts = pts_slot[s:e]
        total = None
        if outputs is not None:
            feat, depth, acc, until = (x[s:e] for x in outputs)
            total = payload_total(feat, depth, acc, g_feat[s:e], g_depth[s:e], g_alpha[s:e], until, g_until[s:e])
        _bwd_chunk(d_table, table, tile_gauss[s:e], tile_valid[s:e], pts[..., 0:1], pts[..., 1:2], pts[..., 3:4],
                   wrap, vmask[s:e] > 0, pts[..., 2:3] - depth_eps, g_feat[s:e], g_depth[s:e], g_alpha[s:e],
                   g_until[s:e], magnitude, total)
    return d_table


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


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _camera_forward(table, tile_gauss, tile_valid, pix, times):
    """K2 on a CUDA device, its plain version on the CPU."""
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
        rc = lib.tile_composite_camera_fwd(
            table.data_ptr(), table.shape[0], c, tile_gauss.data_ptr(), tile_valid.data_ptr(),
            pix.data_ptr(), times.data_ptr(), t_total, p, k,
            feat.data_ptr(), depth.data_ptr(), alpha.data_ptr(), _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"tile_composite_camera_fwd launch failed: cudaError {rc}")
    camera_launches += 1
    return feat, depth, alpha


def _camera_backward(table, tile_gauss, tile_valid, pix, times, feat, depth, alpha, g_feat, g_depth, g_alpha):
    """K3 on a CUDA device, its plain version on the CPU -> d_table [N, 10 + C].
    feat, depth, alpha: the forward's outputs on the same inputs (G follows
    from them)."""
    global camera_bwd_launches
    per_slot = (pix, times, feat, depth, alpha, g_feat, g_depth, g_alpha)
    dev = _device_of(table, tile_gauss, tile_valid, *per_slot)
    c = table.shape[1] - ATTR
    t_total, p, k, c = _check(table, tile_gauss, tile_valid, per_slot, ((2,), (1,), (c,), (1,), (1,), (c,), (1,), (1,)))
    if dev.type == "cpu":
        return tile_composite_camera_bwd_plain(table, tile_gauss, tile_valid, pix, times, g_feat, g_depth, g_alpha,
                                               outputs=(feat, depth, alpha))
    d_table = torch.zeros_like(table)
    if t_total == 0:
        return d_table
    lib = _build.load("tile_composite_bwd")
    with torch.cuda.device(dev):
        rc = lib.tile_composite_camera_bwd(
            table.data_ptr(), table.shape[0], c, tile_gauss.data_ptr(), tile_valid.data_ptr(),
            pix.data_ptr(), times.data_ptr(), t_total, p, k, feat.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            g_feat.data_ptr(), g_depth.data_ptr(), g_alpha.data_ptr(), d_table.data_ptr(), _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"tile_composite_camera_bwd launch failed: cudaError {rc}")
    camera_bwd_launches += 1
    return d_table


def _lidar_forward(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps):
    """K4 on a CUDA device, its plain version on the CPU; the line-of-sight
    sum always computed."""
    global lidar_launches
    dev = _device_of(table, tile_gauss, tile_valid, pts_slot, vmask)
    t_total, p, k, c = _check(table, tile_gauss, tile_valid, (pts_slot, vmask), ((4,), ()))
    if dev.type == "cpu":
        return tile_composite_lidar_plain(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps, True)
    feat = torch.empty((t_total, p, c), device=dev)
    depth, acc, until, med = (torch.empty((t_total, p, 1), device=dev) for _ in range(4))
    if t_total == 0:
        return feat, depth, acc, until, med
    lib = _build.load("tile_composite")
    # scratch: each composited slot's running weight sums (one a query of the warp) and depth, for the median
    records = torch.empty(t_total * k * 34, device=dev)
    with torch.cuda.device(dev):
        rc = lib.tile_composite_lidar_fwd(
            table.data_ptr(), table.shape[0], c, tile_gauss.data_ptr(), tile_valid.data_ptr(),
            pts_slot.data_ptr(), vmask.data_ptr(), t_total, p, k, int(wrap), float(depth_eps),
            feat.data_ptr(), depth.data_ptr(), acc.data_ptr(), until.data_ptr(), med.data_ptr(), records.data_ptr(),
            _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"tile_composite_lidar_fwd launch failed: cudaError {rc}")
    lidar_launches += 1
    return feat, depth, acc, until, med


def _lidar_backward(table, tile_gauss, tile_valid, pts_slot, vmask, feat, depth, acc, until, wrap, depth_eps,
                    g_feat, g_depth, g_alpha, g_until):
    """K5 on a CUDA device, its plain version on the CPU -> d_table [N, 10 + C].
    feat, depth, acc, until: the forward's outputs on the same inputs, the
    line-of-sight sum computed (G follows from them)."""
    global lidar_bwd_launches
    per_slot = (pts_slot, vmask, feat, depth, acc, until, g_feat, g_depth, g_alpha, g_until)
    dev = _device_of(table, tile_gauss, tile_valid, *per_slot)
    c = table.shape[1] - ATTR
    t_total, p, k, c = _check(table, tile_gauss, tile_valid, per_slot,
                              ((4,), (), (c,), (1,), (1,), (1,), (c,), (1,), (1,), (1,)))
    if dev.type == "cpu":
        return tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps,
                                              g_feat, g_depth, g_alpha, g_until, outputs=(feat, depth, acc, until))
    d_table = torch.zeros_like(table)
    if t_total == 0:
        return d_table
    lib = _build.load("tile_composite_bwd")
    with torch.cuda.device(dev):
        rc = lib.tile_composite_lidar_bwd(
            table.data_ptr(), table.shape[0], c, tile_gauss.data_ptr(), tile_valid.data_ptr(),
            pts_slot.data_ptr(), vmask.data_ptr(), t_total, p, k, int(wrap), float(depth_eps),
            feat.data_ptr(), depth.data_ptr(), acc.data_ptr(), until.data_ptr(),
            g_feat.data_ptr(), g_depth.data_ptr(), g_alpha.data_ptr(), g_until.data_ptr(), d_table.data_ptr(),
            _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"tile_composite_lidar_bwd launch failed: cudaError {rc}")
    lidar_bwd_launches += 1
    return d_table


class TileCompositeCamera(torch.autograd.Function):
    """Camera tile composite: forward K2, backward K3 (plain versions on the
    CPU). Only the packed table gets a gradient. Saves its outputs beside its
    inputs: the backward takes G from them."""

    @staticmethod
    def forward(ctx, table, tile_gauss, tile_valid, pix, times):
        out = _camera_forward(table, tile_gauss, tile_valid, pix, times)
        ctx.save_for_backward(table, tile_gauss, tile_valid, pix, times, *out)
        return out

    @staticmethod
    def backward(ctx, g_feat, g_depth, g_alpha):
        d_table = _camera_backward(*ctx.saved_tensors, g_feat.contiguous(), g_depth.contiguous(),
                                   g_alpha.contiguous())
        return d_table, None, None, None, None


class TileCompositeLidar(torch.autograd.Function):
    """Lidar tile composite: forward K4, backward K5 (plain versions on the
    CPU). Only the packed table gets a gradient; the median depth carries none.
    Saves its outputs beside its inputs, the line-of-sight sum computed even
    where the caller gets zeros for it: the backward takes G from them."""

    @staticmethod
    def forward(ctx, table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps, compute_until):
        feat, depth, acc, until, med = _lidar_forward(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps)
        ctx.save_for_backward(table, tile_gauss, tile_valid, pts_slot, vmask, feat, depth, acc, until)
        ctx.wrap, ctx.depth_eps = bool(wrap), float(depth_eps)
        ctx.mark_non_differentiable(med)
        return feat, depth, acc, until if compute_until else torch.zeros_like(until), med

    @staticmethod
    def backward(ctx, g_feat, g_depth, g_alpha, g_until, _g_median):
        d_table = _lidar_backward(*ctx.saved_tensors, ctx.wrap, ctx.depth_eps, g_feat.contiguous(),
                                  g_depth.contiguous(), g_alpha.contiguous(), g_until.contiguous())
        return d_table, None, None, None, None, None, None, None


def tile_composite_camera(table, tile_gauss, tile_valid, pix, times):
    """Camera per-tile composite (K2; differentiable in `table` through K3).
    table [N, 10 + C] f32, tile_gauss [T, K] int32, tile_valid [T, K] f32,
    pix [T, P, 2], times [T, P, 1] ->
    (feat [T, P, C], depth [T, P, 1], alpha [T, P, 1])."""
    return TileCompositeCamera.apply(table, tile_gauss, tile_valid, pix, times)


def tile_composite_lidar(table, tile_gauss, tile_valid, pts_slot, vmask, wrap: bool, depth_eps: float,
                         compute_until: bool):
    """Lidar per-tile composite (K4; differentiable in `table` through K5).
    pts_slot [T, P, 4] (azimuth, elevation, gt depth, time) f32, vmask [T, P]
    f32, the rest as the camera composite ->
    (feat [T, P, C], depth, acc, alpha_sum_until, median_depth [T, P, 1])."""
    return TileCompositeLidar.apply(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps, compute_until)
