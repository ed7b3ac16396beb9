"""Pose algebra and trajectory interpolation (torch port of `neurad_tpu/core/poses.py`).

Only what the SplatAD serving path needs: homogeneous padding, the 6D rotation
representation and the dense trajectory/velocity interpolation used by
`DynamicActors`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def to4x4(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] homogeneous."""
    bottom = torch.zeros_like(pose[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


def multiply(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Compose [..., 3, 4] poses a∘b."""
    r = pose_a[..., :3, :3] @ pose_b[..., :3, :3]
    t = pose_a[..., :3, :3] @ pose_b[..., :3, 3:] + pose_a[..., :3, 3:]
    return torch.cat([r, t], dim=-1)


def rotmat_to_6d(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> 6D rep (first two rows)."""
    return torch.cat([r[..., 0, :], r[..., 1, :]], dim=-1)


def rot6d_to_rotmat(d6: torch.Tensor) -> torch.Tensor:
    """6D rep -> rotation matrix via Gram-Schmidt (Zhou et al. 2019)."""
    a1 = d6[..., :3]
    a2 = d6[..., 3:6]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.norm(a2, dim=-1, keepdim=True).clamp_min(1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def _interp_indices(pose_times: torch.Tensor, query_times: torch.Tensor, clamp_frac: bool):
    qt = query_times.reshape(-1)
    right_idx = torch.searchsorted(pose_times, qt).clamp(1, len(pose_times) - 1)
    left_idx = right_idx - 1
    frac = (qt - pose_times[left_idx]) / (pose_times[right_idx] - pose_times[left_idx] + 1e-6)
    if clamp_frac:
        frac = frac.clamp(0.0, 1.0)
    return left_idx, right_idx, frac


def interpolate_trajectories_6d(
    poses9d: torch.Tensor,
    pose_times: torch.Tensor,
    query_times: torch.Tensor,
    pose_valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """9D (6d rot + 3 pos) trajectory interpolation, dense/masked variant.

    poses9d [A, T, 9], pose_times [T], query_times [Q] or [Q, 1],
    pose_valid_mask [T, A] -> (interp [Q, A, 9], valid [Q, A]).
    """
    a1 = poses9d[..., :3]
    a1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    a2 = poses9d[..., 3:6]
    a2 = a2 - torch.sum(a1 * a2, dim=-1, keepdim=True) * a1
    a2 = a2 / torch.linalg.norm(a2, dim=-1, keepdim=True).clamp_min(1e-8)
    poses = torch.cat([a1, a2, poses9d[..., 6:9]], dim=-1)  # [A, T, 9]

    qt = query_times.reshape(-1)
    right_idx = torch.searchsorted(pose_times, qt).clamp(0, len(pose_times) - 1)
    left_idx = (right_idx - 1).clamp_min(0)
    frac = (qt - pose_times[left_idx]) / (pose_times[right_idx] - pose_times[left_idx] + 1e-6)
    frac = frac.clamp(0.0, 1.0)

    # index_select, not poses[idx]: every query of a chunk picks one of a few
    # timestamps, and on CUDA the backward of advanced indexing with that many
    # repeated indices is a sort and a serial sum per row; index_select's
    # backward adds with atomics
    poses_t_first = poses.transpose(0, 1)  # [T, A, 9]
    pl_ = torch.index_select(poses_t_first, 0, left_idx)
    pr_ = torch.index_select(poses_t_first, 0, right_idx)
    interp = pl_ + (pr_ - pl_) * frac[:, None, None]

    if pose_valid_mask is None:
        valid = torch.ones((len(qt), poses.shape[0]), dtype=torch.bool, device=poses.device)
    else:
        valid = pose_valid_mask[left_idx] | pose_valid_mask[right_idx]
    return interp, valid


def interpolate_velocities(
    velocities: torch.Tensor, pose_times: torch.Tensor, query_times: torch.Tensor, clamp_frac: bool = False
) -> torch.Tensor:
    """Lerp velocities [T, ...] at query times -> [Q, ...]."""
    left_idx, right_idx, frac = _interp_indices(pose_times, query_times, clamp_frac)
    v0 = torch.index_select(velocities, 0, left_idx)
    v1 = torch.index_select(velocities, 0, right_idx)
    frac = frac.reshape(frac.shape + (1,) * (v0.ndim - 1))
    return v0 + (v1 - v0) * frac
