"""Geometry / rendering math (torch port of `neurad_tpu/core/math_utils.py`).

The JAX package's `searchsorted_dense` and `take_along_small` are dense
comparison forms written for its accelerator; here `torch.searchsorted(...,
right=True)` and `torch.gather` compute the same values."""

from __future__ import annotations

from typing import Tuple

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
