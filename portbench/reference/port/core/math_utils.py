"""Geometry / rendering math (torch port of `neurad_tpu/core/math_utils.py`).

The JAX package's `searchsorted_dense` and `take_along_small` are dense
comparison forms written for its accelerator; here `torch.searchsorted(...,
right=True)` and `torch.gather` compute the same values."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def intersect_aabb(
    origins: torch.Tensor, directions: torch.Tensor, aabb: torch.Tensor, max_bound: float = 1e10,
    invalid_value: float = 1e10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray/AABB slab intersection. origins/directions [..., 3]; aabb [6] =
    (xmin, ymin, zmin, xmax, ymax, zmax) -> (t_min, t_max) each [...],
    `invalid_value` where the ray misses."""
    inv_d = 1.0 / directions  # relies on IEEE inf semantics
    tx_min = (aabb[:3] - origins) * inv_d
    tx_max = (aabb[3:] - origins) * inv_d
    t_min = torch.minimum(tx_min, tx_max).amax(dim=-1)
    t_max = torch.maximum(tx_min, tx_max).amin(dim=-1)
    t_min = t_min.clamp(0.0, max_bound)
    t_max = t_max.clamp(0.0, max_bound)
    miss = t_max <= t_min
    return t_min.masked_fill(miss, invalid_value), t_max.masked_fill(miss, invalid_value)


def intersect_obb(
    origins: torch.Tensor, directions: torch.Tensor, obb_r: torch.Tensor, obb_t: torch.Tensor,
    obb_size: torch.Tensor, max_bound: float = 1e10, invalid_value: float = 1e10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray/oriented-box intersection: the rays rotated into the box's frame
    (rotation `obb_r` [3, 3], centre `obb_t` [3]), then the slab test against
    the centred box of side `obb_size` [3]."""
    o = (origins - obb_t) @ obb_r
    d = directions @ obb_r
    aabb = torch.cat([-obb_size / 2.0, obb_size / 2.0], dim=-1)
    return intersect_aabb(o, d, aabb, max_bound=max_bound, invalid_value=invalid_value)


def power_fn(x: torch.Tensor, lam: float = -1.5, max_bound: float = 1e10) -> torch.Tensor:
    """ZipNeRF power transformation (Eq. 4). `lam` is static."""
    if lam == 1:
        return x
    if lam == 0:
        return torch.log1p(x)
    if lam > max_bound:
        return torch.expm1(x)
    if lam < -max_bound:
        return -torch.expm1(-x)
    lam_1 = abs(lam - 1)
    return (lam_1 / lam) * ((x / lam_1 + 1.0) ** lam - 1.0)


def inv_power_fn(x: torch.Tensor, lam: float = -1.5, eps: float = 1e-10, max_bound: float = 1e10) -> torch.Tensor:
    """Inverse of `power_fn`."""
    if lam == 1:
        return x
    if lam == 0:
        return torch.expm1(x)
    if lam > max_bound:
        return torch.log1p(x)
    if lam < -max_bound:
        return -torch.log(1.0 - x)
    lam_1 = abs(lam - 1)
    return ((x * lam / lam_1 + 1.0).clamp_min(eps) ** (1.0 / lam) - 1.0) * lam_1


def erf_approx(x: torch.Tensor) -> torch.Tensor:
    """ZipNeRF's approximation of erf (Eq. 11)."""
    return torch.sign(x) * torch.sqrt(1.0 - torch.exp(-(4.0 / math.pi) * x**2))


def expected_sin(x_means: torch.Tensor, x_vars: torch.Tensor) -> torch.Tensor:
    """E[sin(x)] for x ~ N(mean, var)."""
    return torch.exp(-0.5 * x_vars) * torch.sin(x_means)


def normalized_depth_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The least-squares scale and shift that align a (monocular) depth map
    [..., H, W] to a target over `mask`; 0 and 0 where the system is singular."""
    a_00 = torch.sum(mask * prediction * prediction, dim=(-2, -1))
    a_01 = torch.sum(mask * prediction, dim=(-2, -1))
    a_11 = torch.sum(mask, dim=(-2, -1))
    b_0 = torch.sum(mask * prediction * target, dim=(-2, -1))
    b_1 = torch.sum(mask * target, dim=(-2, -1))
    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    safe = torch.where(valid, det, torch.ones_like(det))
    scale = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe, torch.zeros_like(det))
    shift = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe, torch.zeros_like(det))
    return scale, shift


def chamfer_distance(
    pred: torch.Tensor, gt: torch.Tensor, pred_mask: Optional[torch.Tensor] = None,
    gt_mask: Optional[torch.Tensor] = None, chunk: int = 4096,
) -> torch.Tensor:
    """Symmetric chamfer distance between point clouds pred [N, 3] and gt
    [M, 3], on their device: the mean distance from each valid point of one
    cloud to the nearest valid point of the other, both ways. The optional
    bool masks mark the valid points. The pairwise distances are taken
    `chunk` points of the first cloud at a time."""
    big = 1e12
    if pred_mask is None:
        pred_mask = torch.ones(pred.shape[0], dtype=torch.bool, device=pred.device)
    if gt_mask is None:
        gt_mask = torch.ones(gt.shape[0], dtype=torch.bool, device=gt.device)

    def min_dists(a, a_mask, b, b_mask):
        # for each point of a: the distance to the nearest valid point of b (0 where a is not valid)
        out = []
        for start in range(0, a.shape[0], chunk):
            ac = a[start:start + chunk]
            d2 = (ac[:, None, 0] - b[None, :, 0]) ** 2
            d2 = d2 + (ac[:, None, 1] - b[None, :, 1]) ** 2
            d2 = d2 + (ac[:, None, 2] - b[None, :, 2]) ** 2
            dmin = torch.sqrt(torch.where(b_mask[None, :], d2, big).amin(dim=-1))
            out.append(torch.where(a_mask[start:start + chunk], dmin, 0.0))
        return torch.cat(out) if out else a.new_zeros((0,))

    d_pred = min_dists(pred, pred_mask, gt, gt_mask)
    d_gt = min_dists(gt, gt_mask, pred, pred_mask)
    n_pred = pred_mask.sum().clamp_min(1)
    n_gt = gt_mask.sum().clamp_min(1)
    return d_pred.sum() / n_pred + d_gt.sum() / n_gt
