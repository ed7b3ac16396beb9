"""Pixel and point samplers: the index draws of ray batches (the port's own
copy of `neurad_tpu/data/pixel_samplers.py`; nerfstudio's PixelSampler,
PatchPixelSampler, LidarPointSampler, ScaledPatchSampler and
PairPixelSampler). Host-side numpy, drawn from an explicit generator, so the
same seed gives both packages the same indices; a datamanager turns indices
into rays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def sample_uniform_pixels(
    rng: np.random.Generator, num_rays: int, num_images: int, height: int, width: int
) -> np.ndarray:
    """[N, 3] (image, row, col) uniform indices."""
    return np.stack(
        [
            rng.integers(0, num_images, num_rays),
            rng.integers(0, height, num_rays),
            rng.integers(0, width, num_rays),
        ],
        axis=-1,
    )


def sample_patch_pixels(
    rng: np.random.Generator, num_patches: int, patch_size: int, num_images: int, height: int, width: int
) -> np.ndarray:
    """[N*P*P, 3] indices forming PxP pixel patches."""
    img = rng.integers(0, num_images, num_patches)
    r0 = rng.integers(0, height - patch_size + 1, num_patches)
    c0 = rng.integers(0, width - patch_size + 1, num_patches)
    dr, dc = np.meshgrid(np.arange(patch_size), np.arange(patch_size), indexing="ij")
    rows = r0[:, None, None] + dr
    cols = c0[:, None, None] + dc
    imgs = np.broadcast_to(img[:, None, None], rows.shape)
    return np.stack([imgs, rows, cols], axis=-1).reshape(-1, 3)


def sample_scaled_patches(
    rng: np.random.Generator,
    num_patches: int,
    ray_patch_size: int,
    scale: int,
    num_images: int,
    height: int,
    width: int,
    scores: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """K x K ray patches whose ground truth is (K * scale)^2 pixels, the rays
    at the centres of the scale x scale blocks. Optional `scores`
    [num_images, H, W] weight the patches' placement.

    Returns (ray coords [N*K*K, 3] float (img, row, col), patch origins [N, 3]).
    """
    gt = ray_patch_size * scale
    if scores is not None:
        flat = scores[:, : height - gt + 1, : width - gt + 1].reshape(-1)
        p = flat / flat.sum()
        pick = rng.choice(flat.size, size=num_patches, p=p)
        per = (height - gt + 1) * (width - gt + 1)
        img = pick // per
        rem = pick % per
        r0 = rem // (width - gt + 1)
        c0 = rem % (width - gt + 1)
    else:
        img = rng.integers(0, num_images, num_patches)
        r0 = rng.integers(0, height - gt + 1, num_patches)
        c0 = rng.integers(0, width - gt + 1, num_patches)
    k = np.arange(ray_patch_size) * scale + scale / 2.0
    rows = r0[:, None, None] + k[None, :, None]
    cols = c0[:, None, None] + k[None, None, :]
    imgs = np.broadcast_to(img[:, None, None].astype(np.float64), np.broadcast_shapes(rows.shape, cols.shape))
    rows, cols = np.broadcast_arrays(rows, cols)
    coords = np.stack([imgs, rows, cols], axis=-1).reshape(-1, 3)
    return coords, np.stack([img, r0, c0], axis=-1)


def sample_lidar_points(
    rng: np.random.Generator, num_rays: int, points_per_scan: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Points drawn uniformly over the packed per-scan clouds. Returns
    (scan_idx [N], point_idx [N])."""
    total = int(points_per_scan.sum())
    flat = rng.integers(0, total, num_rays)
    offsets = np.concatenate([[0], np.cumsum(points_per_scan)])
    scan_idx = np.searchsorted(offsets, flat, side="right") - 1
    point_idx = flat - offsets[scan_idx]
    return scan_idx, point_idx


def sample_pair_pixels(
    rng: np.random.Generator, num_pairs: int, num_images: int, height: int, width: int, radius: int = 2
) -> np.ndarray:
    """Pairs of nearby pixels (within `radius`) for the depth-ranking loss.
    Returns [2*N, 3], the pairs interleaved."""
    img = rng.integers(0, num_images, num_pairs)
    r = rng.integers(radius, height - radius, num_pairs)
    c = rng.integers(radius, width - radius, num_pairs)
    dr = rng.integers(-radius, radius + 1, num_pairs)
    dc = rng.integers(-radius, radius + 1, num_pairs)
    first = np.stack([img, r, c], axis=-1)
    second = np.stack([img, r + dr, c + dc], axis=-1)
    out = np.empty((2 * num_pairs, 3), dtype=np.int64)
    out[0::2] = first
    out[1::2] = second
    return out
