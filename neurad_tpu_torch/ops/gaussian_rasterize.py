"""Tile-binned gaussian rasterization for camera pixels and lidar query points
(torch port of `neurad_tpu/ops/gaussian_rasterize.py`).

Static caps as in the JAX package: every gaussian emits up to
`max_tiles_per_gaussian` (tile, gaussian) pairs, pairs are depth-ordered and
grouped by tile, and each tile keeps its first `max_per_tile` gaussians. The
per-tile compositing is `ops/tile_composite.py`: the hand-written kernels on a
CUDA device, their plain versions on the CPU, forward and backward. Both
compute the JAX package's fp32 Pallas composites (`backend="pallas"`), the
port's only backend: "hybrid" and "xla" mean XLA's bf16 composite in the JAX
package, a TPU trade-off with no counterpart in the port, and raise on every
device.

`rasterize_lidar_points` (`lidar_raster_mode="points"`, not the default) is
the JAX package's per-point lidar path, which XLA computes there and plain
PyTorch here: each query point gathers its tile's gaussian slots.

The rasterizers are differentiable in the projected means, velocities,
conics, depths, compensations, the opacities and the features. Binning and
slot assignment produce indices only and run on detached values.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from neurad_tpu_torch.ops.gaussians import Projected
from neurad_tpu_torch.ops.tile_composite import floored_mod, tile_composite_camera, tile_composite_lidar
from neurad_tpu_torch.utils import profiler


class TileBinning(NamedTuple):
    tile_gauss: torch.Tensor  # [T, K] int32 gaussian indices (front-to-back)
    tile_valid: torch.Tensor  # [T, K] bool
    num_tiles_x: int
    num_tiles_y: int
    dropped_pairs: torch.Tensor  # (tile, gaussian) pairs beyond max_per_tile
    cropped_gaussians: torch.Tensor  # gaussians covering > max_tiles_per_gaussian tiles
    culled_visible: torch.Tensor  # visible gaussians beyond max_visible (depth-culled)


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x).to(torch.int32)


def bin_gaussians(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    depths: torch.Tensor,
    grid_min: Tuple[float, float],
    tile_size: Tuple[float, float],
    num_tiles: Tuple[int, int],
    max_tiles_per_gaussian: int = 16,
    max_per_tile: int = 256,
    wrap_x: bool = False,
    max_visible: int = 0,
) -> TileBinning:
    """Assign gaussians to tiles, depth-ordered per tile.

    Works in any 2D coordinate system (pixels or spherical degrees): tile (i, j)
    covers [grid_min + (j, i)*tile_size, +tile_size). wrap_x treats x as
    circular (360° lidar azimuth). max_visible (0 = off) keeps only the nearest
    `max_visible` visible gaussians.
    """
    ntx, nty = num_tiles
    t_total = ntx * nty
    dev = means2d.device
    n = means2d.shape[0]
    c = max_tiles_per_gaussian

    # depth order (front to back); culled gaussians (radius 0) pushed to the back
    order = torch.argsort(torch.where(radii > 0, depths, torch.full_like(depths, float("inf"))), stable=True)
    culled_visible = torch.zeros((), dtype=torch.int32, device=dev)
    if max_visible and max_visible < n:
        culled_visible = ((radii > 0).sum() - max_visible).clamp_min(0).to(torch.int32)
        order = order[:max_visible]
        n = max_visible
    m2 = means2d[order]
    rad = radii[order]
    valid_g = rad > 0

    x0 = _floor_i32((m2[:, 0] - rad - grid_min[0]) / tile_size[0])
    x1 = _floor_i32((m2[:, 0] + rad - grid_min[0]) / tile_size[0])
    y0 = _floor_i32((m2[:, 1] - rad - grid_min[1]) / tile_size[1])
    y1 = _floor_i32((m2[:, 1] + rad - grid_min[1]) / tile_size[1])
    if wrap_x:
        x1 = torch.minimum(x1, x0 + ntx - 1)
    else:
        x0 = x0.clamp(0, ntx - 1)
        x1 = x1.clamp(0, ntx - 1)
    y0 = y0.clamp(0, nty - 1)
    y1 = y1.clamp(0, nty - 1)
    wx = x1 - x0 + 1
    wy = y1 - y0 + 1
    cropped = ((wx * wy > c) & valid_g).sum().to(torch.int32)

    # cap the covered rect at C tiles, recentred on the gaussian
    cx = _floor_i32((m2[:, 0] - grid_min[0]) / tile_size[0])
    cx = cx if wrap_x else cx.clamp(0, ntx - 1)
    cy = _floor_i32((m2[:, 1] - grid_min[1]) / tile_size[1]).clamp(0, nty - 1)
    wx_c = torch.minimum(wx, torch.full_like(wx, c))
    c_over_wx = _floor_i32((float(c) + 0.5) / wx_c.clamp_min(1).to(torch.float32))
    wy_c = torch.minimum(wy, c_over_wx.clamp_min(1))
    x0 = torch.minimum(torch.maximum(cx - wx_c // 2, x0), x1 - wx_c + 1)
    y0 = torch.minimum(torch.maximum(cy - wy_c // 2, y0), y1 - wy_c + 1)
    wx, wy = wx_c, wy_c

    # up to C tile slots per gaussian, row-major over the covered rect
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    inv_wx = 1.0 / wx.clamp_min(1).to(torch.float32)
    sy = _floor_i32((slot[None, :].to(torch.float32) + 0.5) * inv_wx[:, None])
    sx = slot[None, :] - sy * wx.clamp_min(1)[:, None]
    tile_x = x0[:, None] + sx
    if wrap_x:
        tile_x = torch.remainder(tile_x, ntx)
    tile_y = y0[:, None] + sy
    in_rect = (slot[None, :] < (wx * wy)[:, None]) & valid_g[:, None]
    tile_id = torch.where(in_rect, tile_y * ntx + tile_x, torch.full_like(tile_x, t_total))  # sentinel

    # one sort of unique (tile, depth rank) keys: within a tile the pairs stay
    # front to back
    rank = torch.arange(n, dtype=torch.int64, device=dev)
    keys = (tile_id.to(torch.int64) * n + rank[:, None]).reshape(-1)
    sorted_keys = torch.sort(keys).values
    bounds = torch.arange(t_total + 1, dtype=torch.int64, device=dev) * n
    edges = torch.searchsorted(sorted_keys, bounds)
    starts, ends = edges[:-1], edges[1:]
    k = max_per_tile
    gather_idx = starts[:, None] + torch.arange(k, dtype=torch.int64, device=dev)[None, :]  # [T, K]
    tile_valid = gather_idx < ends[:, None]
    gather_idx = gather_idx.clamp(0, sorted_keys.shape[0] - 1)
    tile_gauss = order[sorted_keys[gather_idx] % n].to(torch.int32)
    dropped = (ends - starts - k).clamp_min(0).sum().to(torch.int32)
    return TileBinning(
        tile_gauss=tile_gauss,
        tile_valid=tile_valid,
        num_tiles_x=ntx,
        num_tiles_y=nty,
        dropped_pairs=dropped,
        cropped_gaussians=cropped,
        culled_visible=culled_visible,
    )


def _packed_table(projected: Projected, opac: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """Per-gaussian render attributes in one [N, 10 + C] f32 table, the layout
    the tile composites read (`tile_composite.PACKED_COLUMNS` then features)."""
    return torch.cat(
        [
            projected.means2d,
            projected.vel2d,
            projected.conics,
            opac[:, None],
            projected.depths[:, None],
            projected.depth_vel[:, None],
            features.float(),
        ],
        dim=1,
    ).contiguous()


def _check_backend(backend: str) -> None:
    if backend not in ("pallas", "hybrid", "xla"):
        raise ValueError(f"unknown rasterize backend {backend!r}")
    if backend != "pallas":
        raise NotImplementedError(
            f"rasterize backend {backend!r}: the port computes the fp32 'pallas' composite on every device; "
            "'hybrid' and 'xla' are the JAX package's bf16 XLA composite, a TPU trade-off that is not ported"
        )


def camera_tile_inputs(
    projected: Projected,
    features: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    tile_size: int = 16,
    max_per_tile: int = 256,
    max_tiles_per_gaussian: int = 16,
    rolling_shutter_time: float = 0.0,
    rs_direction: str = "vertical",
    max_visible: int = 0,
):
    """Binning + the camera composite's inputs:
    (binning, table [N, 10+C], tile_valid [T, K] f32, pix [T, P, 2], times [T, P, 1])."""
    dev = features.device
    ntx = -(-width // tile_size)
    nty = -(-height // tile_size)
    binning = bin_gaussians(
        projected.means2d.detach(), projected.radii.detach(), projected.depths.detach(),
        grid_min=(0.0, 0.0),
        tile_size=(float(tile_size), float(tile_size)),
        num_tiles=(ntx, nty),
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        max_per_tile=max_per_tile,
        max_visible=max_visible,
    )
    t_total = ntx * nty

    tile_ids = torch.arange(t_total, dtype=torch.int32, device=dev)
    tx = (tile_ids % ntx).to(torch.float32) * tile_size
    ty = torch.div(tile_ids, ntx, rounding_mode="floor").to(torch.float32) * tile_size
    py, px = torch.meshgrid(
        torch.arange(tile_size, device=dev), torch.arange(tile_size, device=dev), indexing="ij"
    )
    local = torch.stack([px.reshape(-1) + 0.5, py.reshape(-1) + 0.5], dim=-1).to(torch.float32)  # [P, 2]
    pix = (torch.stack([tx, ty], dim=-1)[:, None, :] + local[None, :, :]).contiguous()  # [T, P, 2]
    frac = pix[..., 1] / float(height) if rs_direction == "vertical" else pix[..., 0] / float(width)
    times = ((frac - 0.5) * rolling_shutter_time)[..., None].contiguous()  # [T, P, 1]

    table = _packed_table(projected, opacities * projected.compensations, features)
    return binning, table, binning.tile_valid.to(torch.float32), pix, times


def rasterize_camera(
    projected: Projected,
    features: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    tile_size: int = 16,
    max_per_tile: int = 256,
    max_tiles_per_gaussian: int = 16,
    rolling_shutter_time: float = 0.0,
    rs_direction: str = "vertical",
    backend: str = "pallas",
    return_binning: bool = False,
    max_visible: int = 0,
):
    """Rasterize projected gaussians to (features [H,W,C], depth [H,W,1],
    alpha [H,W,1]) (+ the binning when `return_binning`)."""
    _check_backend(backend)
    with profiler.span("model.bin"):
        binning, table, tile_valid, pix, times = camera_tile_inputs(
            projected, features, opacities, width, height, tile_size, max_per_tile, max_tiles_per_gaussian,
            rolling_shutter_time, rs_direction, max_visible,
        )
        if profiler.is_counting():
            profiler.count("tiles.slots", binning.tile_valid.numel())
            profiler.count("tiles.slots_valid", binning.tile_valid.sum())
            profiler.count("tiles.pairs_dropped", binning.dropped_pairs)
    with profiler.span("model.composite"):
        feat, depth, alpha = tile_composite_camera(table, binning.tile_gauss, tile_valid, pix, times)
        ntx, nty = binning.num_tiles_x, binning.num_tiles_y

        def to_image(x):
            ch = x.shape[-1]
            x = x.reshape(nty, ntx, tile_size, tile_size, ch).permute(0, 2, 1, 3, 4)
            return x.reshape(nty * tile_size, ntx * tile_size, ch)[:height, :width]

        imgs = (to_image(feat), to_image(depth), to_image(alpha))
    return imgs + (binning,) if return_binning else imgs


def lidar_tile_inputs(
    projected: Projected,
    features: torch.Tensor,
    opacities: torch.Tensor,
    raster_pts: torch.Tensor,
    azim_range: Tuple[float, float] = (-180.0, 180.0),
    elev_range: Tuple[float, float] = (-25.0, 15.0),
    tile_size_azim: float = 2.0,
    tile_size_elev: float = 2.0,
    max_per_tile: int = 128,
    max_tiles_per_gaussian: int = 16,
    pts_per_tile: int = 128,
):
    """Binning, slot assignment and the lidar composite's inputs. Query points
    are sorted by tile into a [T, pts_per_tile] slot grid; points beyond a
    tile's capacity are dropped and counted. Returns a dict with the binning,
    table, tile_valid (f32), pts_slot [T, P, 4], valid_slot [T, P] (f32),
    slot_of_pt [M], overflow, wrap."""
    dev = raster_pts.device
    ntx = max(1, int(-(-(azim_range[1] - azim_range[0]) // tile_size_azim)))
    nty = max(1, int(-(-(elev_range[1] - elev_range[0]) // tile_size_elev)))
    wrap = (azim_range[1] - azim_range[0]) >= 360.0 - 1e-6
    binning = bin_gaussians(
        projected.means2d.detach(), projected.radii.detach(), projected.depths.detach(),
        grid_min=(azim_range[0], elev_range[0]),
        tile_size=(tile_size_azim, tile_size_elev),
        num_tiles=(ntx, nty),
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        max_per_tile=max_per_tile,
        wrap_x=wrap,
    )
    t_total = ntx * nty
    m = raster_pts.shape[0]
    p = pts_per_tile

    qx = torch.div(raster_pts[:, 0] - azim_range[0], tile_size_azim, rounding_mode="floor")
    qy = torch.div(raster_pts[:, 1] - elev_range[0], tile_size_elev, rounding_mode="floor")
    q_tile = qy.to(torch.int64).clamp(0, nty - 1) * ntx + qx.to(torch.int64).clamp(0, ntx - 1)  # [M]

    # slot assignment: sort points by tile, rank within tile = position - tile start
    t_sorted, order_s = torch.sort(q_tile, stable=True)
    counts = torch.bincount(q_tile, minlength=t_total)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(m, device=dev) - starts[t_sorted]
    ok = rank < p
    overflow = (~ok).sum().to(torch.int32)
    slot_raw = t_sorted * p + rank
    # overflow ranks would land in the next tile's slots: send them to a
    # dropped extra slot
    slot_masked = torch.where(ok, slot_raw, torch.full_like(slot_raw, t_total * p))
    pt_of_slot = torch.full((t_total * p + 1,), m, dtype=torch.int64, device=dev)
    pt_of_slot[slot_masked] = order_s
    pt_of_slot = pt_of_slot[: t_total * p]
    pts_pad = torch.cat([raster_pts[:, :4], raster_pts.new_zeros((1, 4))])
    pts_slot = pts_pad[pt_of_slot].reshape(t_total, p, 4).contiguous()
    valid_slot = (pt_of_slot < m).reshape(t_total, p).to(torch.float32)
    slot_of_pt = torch.full((m,), t_total * p, dtype=torch.int64, device=dev)
    slot_of_pt[order_s] = slot_masked

    table = _packed_table(projected, opacities * projected.compensations, features)
    return dict(
        binning=binning, table=table, tile_valid=binning.tile_valid.to(torch.float32), pts_slot=pts_slot,
        valid_slot=valid_slot, slot_of_pt=slot_of_pt, overflow=overflow, wrap=wrap,
    )


def rasterize_lidar_points_tiled(
    projected: Projected,
    features: torch.Tensor,
    opacities: torch.Tensor,
    raster_pts: torch.Tensor,
    azim_range: Tuple[float, float] = (-180.0, 180.0),
    elev_range: Tuple[float, float] = (-25.0, 15.0),
    tile_size_azim: float = 2.0,
    tile_size_elev: float = 2.0,
    max_per_tile: int = 128,
    max_tiles_per_gaussian: int = 16,
    compute_alpha_sum_until_points: bool = True,
    depth_eps: float = 0.4,
    pts_per_tile: int = 128,
    backend: str = "pallas",
) -> dict:
    """Rasterize gaussians at spherical query points raster_pts [M, >=4]
    (azim_deg, elev_deg, gt_depth, time), grouped by tile. Returns per-point
    features/depth/alpha, alpha accumulated in front of the gt depth, median
    depth and the overflow counters."""
    _check_backend(backend)
    with profiler.span("model.bin"):
        ti = lidar_tile_inputs(
            projected, features, opacities, raster_pts, azim_range, elev_range, tile_size_azim, tile_size_elev,
            max_per_tile, max_tiles_per_gaussian, pts_per_tile,
        )
    with profiler.span("model.composite"):
        feat, depth, acc, until, med = tile_composite_lidar(
            ti["table"], ti["binning"].tile_gauss, ti["tile_valid"], ti["pts_slot"], ti["valid_slot"],
            ti["wrap"], depth_eps, compute_alpha_sum_until_points,
        )
        slot_of_pt = ti["slot_of_pt"]

        def per_point(x):
            flat = x.reshape(-1, x.shape[-1])
            flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])  # overflow -> zero row
            # index_select: its backward adds with atomics; advanced indexing's backward sorts, which is
            # slow where many points share the overflow row
            return torch.index_select(flat, 0, slot_of_pt)

        binning = ti["binning"]
        return {
            "features": per_point(feat),
            "depth": per_point(depth),
            "alpha": per_point(acc),
            "alpha_sum_until_points": per_point(until),
            "median_depth": per_point(med),
            "binning_dropped_pairs": binning.dropped_pairs,
            "binning_cropped_gaussians": binning.cropped_gaussians,
            "points_overflowed": ti["overflow"],
        }


def rasterize_lidar_points(
    projected: Projected,
    features: torch.Tensor,
    opacities: torch.Tensor,
    raster_pts: torch.Tensor,
    azim_range: Tuple[float, float] = (-180.0, 180.0),
    elev_range: Tuple[float, float] = (-25.0, 15.0),
    tile_size_azim: float = 2.0,
    tile_size_elev: float = 2.0,
    max_per_tile: int = 128,
    max_tiles_per_gaussian: int = 16,
    compute_alpha_sum_until_points: bool = True,
    depth_eps: float = 0.4,
    point_chunk: int = 0,
) -> dict:
    """Rasterize gaussians at spherical query points raster_pts [M, >= 4]
    (azim_deg, elev_deg, gt_depth, time), point by point: each point takes
    the K = `max_per_tile` gaussian slots of its tile and composites them
    front to back. The JAX package's math: the offsets subtracted in fp32
    (the azimuth's wrapped to [-180, 180) on a full turn), the quadratic form
    in bf16, alpha = min(opacity * exp(-clip(sigma, 0, 50)), 0.999) gated at
    1/255, the median the depth of the first slot whose cumulative weight
    reaches 0.5 (absolute; below an accumulation of 0.5 the normalised
    expected depth), and the alpha summed before `gt_depth - depth_eps`.

    Memory: the per-point gathers hold [M, K] slots of the gaussian's row, so
    the working set is about M * K * (C + 12) * 4 bytes for C feature
    channels, and that again for the backward: 131,072 points x 128 slots x
    (8 + 12) floats are 1.3 GB a pass. `point_chunk` > 0 runs chunks of that
    many points, recomputed in the backward (`torch.utils.checkpoint`, JAX's
    `jax.checkpoint`), so the working set is a chunk's.

    Returns per-point features, depth, alpha, alpha_sum_until_points and
    median_depth, and the binning's counters."""
    ntx = max(1, int(-(-(azim_range[1] - azim_range[0]) // tile_size_azim)))
    nty = max(1, int(-(-(elev_range[1] - elev_range[0]) // tile_size_elev)))
    wrap = (azim_range[1] - azim_range[0]) >= 360.0 - 1e-6
    binning = bin_gaussians(
        projected.means2d.detach(), projected.radii.detach(), projected.depths.detach(),
        grid_min=(azim_range[0], elev_range[0]), tile_size=(tile_size_azim, tile_size_elev),
        num_tiles=(ntx, nty), max_tiles_per_gaussian=max_tiles_per_gaussian, max_per_tile=max_per_tile,
        wrap_x=wrap,
    )
    m = raster_pts.shape[0]
    pts_all = raster_pts[:, :4]
    qx = torch.div(pts_all[:, 0] - azim_range[0], tile_size_azim, rounding_mode="floor")
    qy = torch.div(pts_all[:, 1] - elev_range[0], tile_size_elev, rounding_mode="floor")
    q_tile = qy.to(torch.int64).clamp(0, nty - 1) * ntx + qx.to(torch.int64).clamp(0, ntx - 1)  # [M]
    opac = opacities * projected.compensations
    tile_gauss = binning.tile_gauss.long()

    def chunk_fn(pts, tile_idx, means2d, vel2d, conics, depths, depth_vel, opac, features):
        tg = tile_gauss[tile_idx]  # [mc, K]
        tv = binning.tile_valid[tile_idx]
        means = means2d[tg] + vel2d[tg] * pts[:, None, 3:4]  # the rolling-shutter warp
        d = pts[:, None, :2] - means
        if wrap:  # a circular azimuth: -179.5 deg is 1.1 deg from +179.4 deg
            d = torch.stack([floored_mod(d[..., 0] + 180.0, 360.0) - 180.0, d[..., 1]], dim=-1)
        d = d.to(torch.bfloat16)
        con = conics[tg].to(torch.bfloat16)
        sigma = (0.5 * (con[..., 0] * d[..., 0] ** 2 + con[..., 2] * d[..., 1] ** 2)
                 + con[..., 1] * d[..., 0] * d[..., 1]).to(torch.float32)
        alpha = torch.clamp(opac[tg] * torch.exp(-torch.clamp(sigma, 0.0, 50.0)), 0.0, 0.999)
        alpha = torch.where(tv & (alpha >= 1.0 / 255.0), alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - alpha
        trans = torch.cat([torch.ones_like(one_minus[..., :1]), torch.cumprod(one_minus, dim=-1)[..., :-1]], dim=-1)
        w = alpha * trans  # [mc, K]
        g_depth = depths[tg] + depth_vel[tg] * pts[:, None, 3]
        feat = torch.einsum("mk,mkc->mc", w, features[tg])
        depth = torch.sum(w * g_depth, dim=-1, keepdim=True)
        acc = torch.sum(w, dim=-1, keepdim=True)
        crossed = torch.cumsum(w, dim=-1) >= 0.5
        med_idx = crossed.to(torch.uint8).argmax(dim=-1)
        median_depth = torch.gather(g_depth, -1, med_idx[:, None])
        median_depth = torch.where(acc > 0.5, median_depth, depth / acc.clamp_min(1e-10))
        if compute_alpha_sum_until_points:
            before = g_depth < (pts[:, None, 2] - depth_eps)
            alpha_until = torch.sum(torch.where(before, w, torch.zeros_like(w)), dim=-1, keepdim=True)
        else:
            alpha_until = torch.zeros_like(acc)
        return feat, depth, acc, alpha_until, median_depth

    tensors = (projected.means2d, projected.vel2d, projected.conics, projected.depths, projected.depth_vel, opac,
               features)
    if point_chunk and m > point_chunk:
        parts = []
        for start in range(0, m, point_chunk):
            args = (pts_all[start:start + point_chunk], q_tile[start:start + point_chunk]) + tensors
            parts.append(checkpoint(chunk_fn, *args, use_reentrant=False) if torch.is_grad_enabled()
                         else chunk_fn(*args))
        feat, depth, acc, alpha_until, med = (torch.cat(xs, dim=0) for xs in zip(*parts))
    else:
        feat, depth, acc, alpha_until, med = chunk_fn(pts_all, q_tile, *tensors)
    return {
        "features": feat,
        "depth": depth,
        "alpha": acc,
        "alpha_sum_until_points": alpha_until,
        "median_depth": med,
        "binning_dropped_pairs": binning.dropped_pairs,
        "binning_cropped_gaussians": binning.cropped_gaussians,
    }
