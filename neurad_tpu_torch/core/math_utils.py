"""Geometry / rendering math (torch port of `neurad_tpu/core/math_utils.py`).

The JAX package's `searchsorted_dense` and `take_along_small` are dense
comparison forms written for its accelerator; here `torch.searchsorted(...,
right=True)` and `torch.gather` compute the same values."""

from __future__ import annotations

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
