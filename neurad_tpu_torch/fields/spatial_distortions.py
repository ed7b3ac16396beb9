"""Spatial distortions: MipNeRF-360 scene contraction, linearised for
gaussians as in ZipNeRF (torch port of
`neurad_tpu/fields/spatial_distortions.py`). Pure functions."""

from __future__ import annotations

from typing import Optional

import torch

from neurad_tpu_torch.core.structs import GaussiansStd


def _norm(x: torch.Tensor, order: Optional[float]) -> torch.Tensor:
    if order is None or order == 2:
        return torch.linalg.norm(x, dim=-1, keepdim=True)
    if order == float("inf"):
        return x.abs().amax(dim=-1, keepdim=True)
    return torch.sum(x.abs() ** order, dim=-1, keepdim=True) ** (1.0 / order)


def scene_contraction(positions: torch.Tensor, order: Optional[float] = float("inf")) -> torch.Tensor:
    """Identity inside the unit ball, 2 - 1/||x|| outside. The L_inf order
    contracts to a cube of side 4."""
    mag = _norm(positions, order)
    clamped = mag.clamp_min(1.0)
    return torch.where(mag < 1, positions, (2.0 - 1.0 / clamped) * (positions / clamped))


def scene_contraction_gaussian(g: GaussiansStd, order: Optional[float] = float("inf")) -> GaussiansStd:
    """Linearised contraction of isotropic gaussians: std scaled by
    ((2|x| - 1)^(1/3) / |x|)^2 outside the unit ball."""
    mag = _norm(g.mean, order)
    mask = mag < 1
    clamped = mag.clamp_min(1.0)
    mean = torch.where(mask, g.mean, (2.0 - 1.0 / clamped) * (g.mean / clamped))
    std_scaling = ((2.0 * clamped - 1.0) ** (1.0 / 3.0) / clamped) ** 2
    std = torch.where(mask, g.std, g.std * std_scaling)
    return GaussiansStd(mean=mean, std=std)


def scaled_scene_contraction(
    positions: torch.Tensor, scale: float, order: Optional[float] = float("inf"), normalize: bool = True
) -> torch.Tensor:
    """Pre-scale, contract, then map the [-2, 2] cube into [0, 1] for the hashgrid lookup."""
    x = scene_contraction(positions / scale, order)
    if normalize:
        x = (x + 2.0) / 4.0
    return x


def scaled_scene_contraction_gaussian(
    g: GaussiansStd, scale: float, order: Optional[float] = float("inf"), normalize: bool = True
) -> GaussiansStd:
    g = GaussiansStd(mean=g.mean / scale, std=g.std / scale)
    g = scene_contraction_gaussian(g, order)
    if normalize:
        g = GaussiansStd(mean=(g.mean + 2.0) / 4.0, std=g.std / 4.0)
    return g
