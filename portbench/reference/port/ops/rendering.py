"""Volume-rendering primitives: transmittance weights and weighted
accumulation (torch port of `neurad_tpu/ops/rendering.py`). Samples per ray
are fixed, so the transmittance scan is a cumulative product along the sample
axis and accumulation a sum."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def render_weights_from_density(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = (1 - exp(-sigma_i delta_i)) * exp(-sum_{j<i} sigma_j delta_j). [..., S, 1] -> [..., S, 1]."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    trans = torch.cumsum(delta_density[..., :-1, :], dim=-2)
    trans = torch.exp(-torch.cat([torch.zeros_like(trans[..., :1, :]), trans], dim=-2))
    return torch.nan_to_num(alphas * trans)


def render_weights_from_alpha(alphas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j). Returns (weights, transmittance [..., S + 1, 1])."""
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[..., :1, :]), 1.0 - alphas + 1e-7], dim=-2), dim=-2)
    return alphas * trans[..., :-1, :], trans


def accumulate_along_rays(weights: torch.Tensor, values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_i w_i * v_i along the sample axis. weights [..., S, 1]; values
    [..., S, C] or None (accumulates the weights) -> [..., C] (or [..., 1])."""
    if values is None:
        return torch.sum(weights, dim=-2)
    return torch.sum(weights * values, dim=-2)


def render_depth_expected(weights: torch.Tensor, steps: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Expected depth sum w t / sum w, clipped to the steps' range."""
    depth = accumulate_along_rays(weights, steps) / accumulate_along_rays(weights).clamp_min(eps)
    return torch.minimum(torch.maximum(depth, steps[..., 0, :]), steps[..., -1, :])


def render_depth_median(weights: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Median depth: the first step where the cumulative weight reaches 0.5
    (the last step where it never does)."""
    crossed = torch.cumsum(weights[..., 0], dim=-1) >= 0.5  # [..., S]
    idx = crossed.to(torch.uint8).argmax(dim=-1)
    idx = torch.where(crossed.any(dim=-1), idx, torch.full_like(idx, steps.shape[-2] - 1))
    return torch.gather(steps[..., 0], -1, idx[..., None])
