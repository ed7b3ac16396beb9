"""Renderers: weighted reductions of per-sample quantities into per-ray
outputs (torch port of `neurad_tpu/model_components/renderers.py`; nerfstudio's
FeatureRenderer, RGBRenderer, AccumulationRenderer, DepthRenderer,
NormalsRenderer, SHRenderer, UncertaintyRenderer and SemanticRenderer as
functions over `ops/rendering.py`). Weights are [..., S, 1]."""

from __future__ import annotations

from typing import Optional

import torch

from neurad_tpu_torch.ops import rendering as R
from neurad_tpu_torch.ops.spherical_harmonics import components_from_spherical_harmonics


def render_features(weights: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """sum w * f along the samples."""
    return R.accumulate_along_rays(weights, features)


def render_rgb(weights: torch.Tensor, rgb: torch.Tensor, background_color: Optional[torch.Tensor] = None,
               accumulation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum w * rgb, composited over `background_color` by the leftover
    accumulation when one is given."""
    comp_rgb = R.accumulate_along_rays(weights, rgb)
    if background_color is not None:
        if accumulation is None:
            accumulation = R.accumulate_along_rays(weights)
        comp_rgb = comp_rgb + background_color * (1.0 - accumulation)
    return comp_rgb


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """sum w."""
    return R.accumulate_along_rays(weights)


def render_depth(weights: torch.Tensor, ray_samples_steps: torch.Tensor, method: str = "median") -> torch.Tensor:
    """The "median" or "expected" depth; `ray_samples_steps` [..., S, 1] are the
    samples' midpoints."""
    if method == "median":
        return R.render_depth_median(weights, ray_samples_steps)
    if method == "expected":
        return R.render_depth_expected(weights, ray_samples_steps)
    raise ValueError(f"unknown depth method {method}")


def render_normals(weights: torch.Tensor, normals: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """sum w * n, normalised (the norm clipped at 1e-8) unless asked not to."""
    n = R.accumulate_along_rays(weights, normals)
    if normalize:
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-8)
    return n


def render_sh(weights: torch.Tensor, sh_coeffs: torch.Tensor, directions: torch.Tensor, levels: int) -> torch.Tensor:
    """Each sample's colour from its spherical-harmonic coefficients
    [..., S, levels^2 * 3] at the ray's direction [..., 3], offset by 0.5 and
    clipped to [0, 1], then accumulated."""
    basis = components_from_spherical_harmonics(levels, directions)  # [..., levels^2]
    coeffs = sh_coeffs.reshape(sh_coeffs.shape[:-1] + (levels**2, 3))
    rgb = torch.einsum("...k,...kc->...c", basis[..., None, :].expand(coeffs.shape[:-1]), coeffs)
    rgb = torch.clamp(rgb + 0.5, 0.0, 1.0)
    return R.accumulate_along_rays(weights, rgb)


def render_uncertainty(weights: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """sum w * beta."""
    return R.accumulate_along_rays(weights, betas)


def render_semantics(weights: torch.Tensor, semantics: torch.Tensor) -> torch.Tensor:
    """sum w * logits."""
    return R.accumulate_along_rays(weights, semantics)
