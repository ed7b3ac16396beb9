"""Pose algebra and trajectory interpolation (torch port of `neurad_tpu/core/poses.py`).

Homogeneous padding, rigid inverse and composition, translation
normalisation, the axis-angle between two rotations, quaternions and the 6D rotation representation, the
dense trajectory/velocity interpolation used by `DynamicActors`, and the slerp
trajectory interpolation the dataparsers resample actor tracks with.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def to4x4(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] homogeneous."""
    bottom = torch.zeros_like(pose[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """Invert [..., 3, 4] rigid poses: R^T, -R^T t (`nerfstudio/utils/poses.py:38-52`)."""
    r_inv = pose[..., :3, :3].transpose(-1, -2)
    return torch.cat([r_inv, -(r_inv @ pose[..., :3, 3:])], dim=-1)


def multiply(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Compose [..., 3, 4] poses a∘b."""
    r = pose_a[..., :3, :3] @ pose_b[..., :3, :3]
    t = pose_a[..., :3, :3] @ pose_b[..., :3, 3:] + pose_a[..., :3, 3:]
    return torch.cat([r, t], dim=-1)


def normalize(poses: torch.Tensor) -> torch.Tensor:
    """Poses [..., 3|4, 4] with their translations divided by the largest
    absolute translation component of all of them, so they lie in [-1, 1]
    (`nerfstudio/utils/poses.py:71-87`)."""
    out = poses.clone()
    out[..., :3, 3] = poses[..., :3, 3] / poses[..., :3, 3].abs().max()
    return out


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Apply [..., 3, 4] poses to [..., N, 3] points."""
    return points @ pose[..., :3, :3].transpose(-1, -2) + pose[..., None, :3, 3]


def rotmat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (xyzw): all four
    candidate quaternions, the one with the largest pivot picked."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt((1.0 + tr).clamp_min(1e-12)) / 2.0
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(1e-12)) / 2.0
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1), (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp_min(1e-12)) / 2.0
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2), (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp_min(1e-12)) / 2.0
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3, (m10 - m01) / (4 * qz3)], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (xyzw) -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between unit quaternions along the shortest arc
    (a lerp where they are nearly parallel)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs().clamp(-1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    frac = torch.as_tensor(frac, dtype=q0.dtype, device=q0.device)
    if frac.dim() == q0.dim() - 1:
        frac = frac[..., None]
    use_lerp = sin_theta < 1e-5
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - frac, torch.sin((1.0 - frac) * theta) / safe_sin)
    w1 = torch.where(use_lerp, frac, torch.sin(frac * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


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


def interpolate_trajectories(
    poses: torch.Tensor, pose_times: torch.Tensor, query_times: torch.Tensor, clamp_frac: bool = True
) -> torch.Tensor:
    """Slerp the rotations and lerp the positions of actor poses at query times.

    poses [T, A, 3, 4], pose_times [T] sorted, query_times [Q] or [Q, 1] ->
    [Q, A, 3, 4]. Without `clamp_frac` a query outside the track extrapolates
    from its first or last pair of poses.
    """
    left_idx, right_idx, frac = _interp_indices(pose_times, query_times, clamp_frac)
    quat = rotmat_to_quat(poses[..., :3, :3])
    q0, q1 = quat[left_idx], quat[right_idx]
    rot = quat_to_rotmat(quat_slerp(q0, q1, frac[:, None].expand(q0.shape[:-1])))
    p0 = poses[left_idx][..., :3, 3]
    p1 = poses[right_idx][..., :3, 3]
    pos = p0 + (p1 - p0) * frac[:, None, None]
    return torch.cat([rot, pos[..., None]], dim=-1)


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


def rotation_difference(rot1: torch.Tensor, rot2: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] of the rotation from rot1 to rot2 [..., 3, 3]
    (`nerfstudio/utils/poses.py:221-249`): theta = arccos((tr(R1^T R2) - 1) / 2),
    the argument clipped to [-1, 1], times the skew part's direction, its norm
    floored at 1e-8.

    Where the clipped argument is +-1 (theta 0 or pi) arccos has no finite
    derivative, and the JAX function's gradient is NaN there. Its value there
    is a constant (0 or pi), so the port takes the constant and leaves arccos
    an argument of 0: the same values, a finite gradient."""
    r_rel = rot1.transpose(-2, -1) @ rot2
    trace = r_rel[..., 0, 0] + r_rel[..., 1, 1] + r_rel[..., 2, 2]
    cos = ((trace - 1.0) / 2.0).clamp(-1.0, 1.0)
    inside = cos.abs() < 1.0
    theta = torch.where(inside, torch.arccos(torch.where(inside, cos, torch.zeros_like(cos))),
                        torch.where(cos > 0, 0.0, torch.pi).to(cos.dtype))
    axis = torch.stack(
        [
            r_rel[..., 2, 1] - r_rel[..., 1, 2],
            r_rel[..., 0, 2] - r_rel[..., 2, 0],
            r_rel[..., 1, 0] - r_rel[..., 0, 1],
        ],
        dim=-1,
    )
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True).clamp_min(1e-8)
    return theta[..., None] * axis
