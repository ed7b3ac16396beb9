"""Lie-group exponential maps for camera-pose deltas (torch port of
`neurad_tpu/core/lie.py`)."""

from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _so3_exp(log_rot: torch.Tensor, eps: float = 1e-4):
    theta2 = torch.sum(log_rot**2, dim=-1)
    theta = torch.sqrt(theta2.clamp_min(eps**2))
    small = theta2 < eps**2
    sin_t_over_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    one_minus_cos_over_t2 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    k = _skew(log_rot)
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device).expand(k.shape)
    r = eye + sin_t_over_t[..., None, None] * k + one_minus_cos_over_t2[..., None, None] * (k @ k)
    return r, k, theta2, sin_t_over_t, one_minus_cos_over_t2


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """[..., 6] (t, log_rot) -> [..., 3, 4]: rotation exp + raw translation."""
    r, *_ = _so3_exp(tangent[..., 3:6])
    return torch.cat([r, tangent[..., :3, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """[..., 6] SE(3) exponential -> [..., 3, 4]."""
    t = tangent[..., :3]
    r, k, theta2, _, one_minus_cos_over_t2 = _so3_exp(tangent[..., 3:6])
    theta = torch.sqrt(theta2.clamp_min(1e-8))
    small = theta2 < 1e-8
    # V = I + (1-cos)/theta^2 K + (theta - sin)/theta^3 K^2
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(k.shape)
    v = eye + one_minus_cos_over_t2[..., None, None] * k + b[..., None, None] * (k @ k)
    return torch.cat([r, v @ t[..., None]], dim=-1)
