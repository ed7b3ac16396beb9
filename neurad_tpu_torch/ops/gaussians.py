"""3D gaussian math: covariance build, camera EWA projection, spherical (lidar)
projection, rolling-shutter velocities (torch port of `neurad_tpu/ops/gaussians.py`).

Conventions: viewmat = world->camera [4,4] with OpenCV camera axes (x right,
y down, z forward). Quats are (w, x, y, z). Covariances travel as six flat [N]
entries (xx, xy, xz, yy, yz, zz), the JAX package's structure-of-arrays form.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


def quat_scale_to_covar6(quats: torch.Tensor, scales: torch.Tensor):
    """[N,4] wxyz quats + [N,3] scales -> six [N] entries of R S S R^T."""
    w, x, y, z = (quats[..., i] for i in range(4))
    n = torch.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    r = (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )
    s0, s1, s2 = scales[..., 0] ** 2, scales[..., 1] ** 2, scales[..., 2] ** 2

    def entry(i, j):
        return r[3 * i] * r[3 * j] * s0 + r[3 * i + 1] * r[3 * j + 1] * s1 + r[3 * i + 2] * r[3 * j + 2] * s2

    return (entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2))


def _rotate_covar6(R: torch.Tensor, c6):
    """R Σ R^T with R [3,3] and Σ six [N] entries; returns six [N] entries."""
    S = ((c6[0], c6[1], c6[2]), (c6[1], c6[3], c6[4]), (c6[2], c6[4], c6[5]))
    t = [[sum(S[k][l] * R[j, l] for l in range(3)) for k in range(3)] for j in range(3)]
    out = {}
    for i in range(3):
        for j in range(i, 3):
            out[(i, j)] = sum(R[i, k] * t[j][k] for k in range(3))
    return (out[(0, 0)], out[(0, 1)], out[(0, 2)], out[(1, 1)], out[(1, 2)], out[(2, 2)])


def _bilinear6(j0, j1, c6):
    """j0 Σ j1^T for per-row 3-vectors j0/j1 (tuples of [N]) and Σ six [N] entries."""
    S00, S01, S02, S11, S12, S22 = c6
    t0 = S00 * j1[0] + S01 * j1[1] + S02 * j1[2]
    t1 = S01 * j1[0] + S11 * j1[1] + S12 * j1[2]
    t2 = S02 * j1[0] + S12 * j1[1] + S22 * j1[2]
    return j0[0] * t0 + j0[1] * t1 + j0[2] * t2


class Projected(NamedTuple):
    """Per-gaussian screen-space quantities."""

    means2d: torch.Tensor  # [N, 2] pixel coords (or azimuth/elevation degrees)
    depths: torch.Tensor  # [N]
    conics: torch.Tensor  # [N, 3] upper-tri of inv 2D cov (a, b, c): [[a,b],[b,c]]
    radii: torch.Tensor  # [N] screen radius, 0 = culled
    compensations: torch.Tensor  # [N] antialiasing opacity compensation
    vel2d: torch.Tensor  # [N, 2] screen-space velocity (rolling shutter)
    depth_vel: torch.Tensor  # [N] range rate (lidar RS; 0 for camera)


def _relative_velocity(p, rot, velocities, linear_velocity, angular_velocity):
    vel = torch.zeros_like(p)
    if velocities is not None:
        vel = vel + velocities @ rot.T
    if linear_velocity is not None:
        vel = vel - linear_velocity[None, :]
    if angular_velocity is not None:
        vel = vel - torch.linalg.cross(angular_velocity.expand(p.shape), p, dim=-1)
    return vel


def project_gaussians_camera(
    means: torch.Tensor,
    covar6: Tuple[torch.Tensor, ...],
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    velocities: Optional[torch.Tensor] = None,
    camera_linear_velocity: Optional[torch.Tensor] = None,
    camera_angular_velocity: Optional[torch.Tensor] = None,
    near_plane: float = 0.5,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    radius_clip: float = 0.0,
    antialiased: bool = True,
) -> Projected:
    """EWA perspective projection of 3D gaussians (gsplat `fully_fused_projection`
    semantics). velocities: per-gaussian world-frame velocity [N,3]; camera
    velocities are in the camera frame. Returns the pixel-space velocity of
    each gaussian for per-pixel-time rolling-shutter warping."""
    r_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]
    p_cam = means @ r_wc.T + t_wc  # [N, 3]
    depths = p_cam[..., 2]

    # behind-camera gaussians are culled below; a safe dummy keeps their huge
    # projected values out of every division
    safe = depths > near_plane
    p_cam = torch.where(safe[:, None], p_cam, p_cam.new_tensor([0.0, 0.0, 1.0]))

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = p_cam[..., 2].clamp_min(1e-6)
    x_ndc = p_cam[..., 0] / z
    y_ndc = p_cam[..., 1] / z
    means2d = torch.stack([fx * x_ndc + cx, fy * y_ndc + cy], dim=-1)

    c6_cam = _rotate_covar6(r_wc, covar6)
    zero = torch.zeros_like(z)
    j0 = (fx / z, zero, -fx * x_ndc / z)
    j1 = (zero, fy / z, -fy * y_ndc / z)
    cov_a = _bilinear6(j0, j0, c6_cam)
    cov_b = _bilinear6(j0, j1, c6_cam)
    cov_c = _bilinear6(j1, j1, c6_cam)

    det_orig = cov_a * cov_c - cov_b**2
    cov_a = cov_a + eps2d
    cov_c = cov_c + eps2d
    det = cov_a * cov_c - cov_b**2
    compensations = torch.sqrt((det_orig / det.clamp_min(1e-12)).clamp_min(1e-12))
    if not antialiased:
        compensations = torch.ones_like(compensations)

    det_safe = det.clamp_min(1e-12)
    conics = torch.stack([cov_c / det_safe, -cov_b / det_safe, cov_a / det_safe], dim=-1)

    # 3-sigma screen radius
    b = 0.5 * (cov_a + cov_c)
    v1 = b + torch.sqrt((b * b - det).clamp_min(0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))

    in_frustum = (depths > near_plane) & (depths < far_plane)
    on_screen = (
        (means2d[..., 0] + radius > 0)
        & (means2d[..., 0] - radius < width)
        & (means2d[..., 1] + radius > 0)
        & (means2d[..., 1] - radius < height)
    )
    valid = in_frustum & on_screen & (radius > radius_clip)
    radii = torch.where(valid, radius, torch.zeros_like(radius))

    vel_cam = _relative_velocity(p_cam, r_wc, velocities, camera_linear_velocity, camera_angular_velocity)
    vel2d = torch.stack(
        [
            fx * (vel_cam[..., 0] / z - x_ndc * vel_cam[..., 2] / z),
            fy * (vel_cam[..., 1] / z - y_ndc * vel_cam[..., 2] / z),
        ],
        dim=-1,
    )
    return Projected(
        means2d=means2d,
        depths=depths,
        conics=conics,
        radii=radii,
        compensations=compensations,
        vel2d=vel2d,
        depth_vel=torch.zeros_like(depths),
    )


def project_gaussians_lidar(
    means: torch.Tensor,
    covar6: Tuple[torch.Tensor, ...],
    viewmat: torch.Tensor,
    velocities: Optional[torch.Tensor] = None,
    lidar_linear_velocity: Optional[torch.Tensor] = None,
    lidar_angular_velocity: Optional[torch.Tensor] = None,
    min_range: float = 0.2,
    max_range: float = 300.0,
    eps2d_deg: float = 0.02,
) -> Projected:
    """Project gaussians into spherical (azimuth, elevation) degrees for lidar
    rasterization. depths = range (m); conics are the inverse covariance in
    degrees^2; depth_vel is the range rate used to rolling-shutter-correct the
    per-point expected depth."""
    r_wl = viewmat[:3, :3]
    t_wl = viewmat[:3, 3]
    p = means @ r_wl.T + t_wl  # sensor frame [N, 3]
    true_rng = torch.linalg.norm(p, dim=-1)
    safe = true_rng > min_range
    p = torch.where(safe[:, None], p, p.new_tensor([1.0, 0.0, 0.0]))
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2d = torch.sqrt((x * x + y * y).clamp_min(1e-12))
    rng = torch.sqrt((x * x + y * y + z * z).clamp_min(1e-12))
    azim = torch.rad2deg(torch.atan2(y, x))
    elev = torch.rad2deg(torch.atan2(z, r2d.clamp_min(1e-9)))
    means2d = torch.stack([azim, elev], dim=-1)

    # Jacobian of (azim_deg, elev_deg) wrt xyz
    rad2deg = 180.0 / math.pi
    r2d_s = r2d.clamp_min(1e-9)
    rng_s = rng.clamp_min(1e-9)
    j00 = -y / (r2d_s**2) * rad2deg
    j01 = x / (r2d_s**2) * rad2deg
    j02 = torch.zeros_like(x)
    j10 = -x * z / (r2d_s * rng_s**2) * rad2deg
    j11 = -y * z / (r2d_s * rng_s**2) * rad2deg
    j12 = r2d_s / rng_s**2 * rad2deg
    c6_l = _rotate_covar6(r_wl, covar6)
    cov_a = _bilinear6((j00, j01, j02), (j00, j01, j02), c6_l)
    cov_b = _bilinear6((j00, j01, j02), (j10, j11, j12), c6_l)
    cov_c = _bilinear6((j10, j11, j12), (j10, j11, j12), c6_l)
    det_orig = cov_a * cov_c - cov_b**2
    cov_a = cov_a + eps2d_deg**2
    cov_c = cov_c + eps2d_deg**2
    det = cov_a * cov_c - cov_b**2
    compensations = torch.sqrt((det_orig / det.clamp_min(1e-12)).clamp_min(1e-12))
    det_safe = det.clamp_min(1e-12)
    conics = torch.stack([cov_c / det_safe, -cov_b / det_safe, cov_a / det_safe], dim=-1)
    b = 0.5 * (cov_a + cov_c)
    v1 = b + torch.sqrt((b * b - det).clamp_min(1e-6))
    radius = 3.0 * torch.sqrt(v1)  # degrees

    valid = safe & (true_rng < max_range)
    radii = torch.where(valid, radius, torch.zeros_like(radius))

    vel_l = _relative_velocity(p, r_wl, velocities, lidar_linear_velocity, lidar_angular_velocity)
    v0, v1_, v2 = vel_l[..., 0], vel_l[..., 1], vel_l[..., 2]
    vel2d = torch.stack([j00 * v0 + j01 * v1_ + j02 * v2, j10 * v0 + j11 * v1_ + j12 * v2], dim=-1)
    depth_vel = torch.sum(p * vel_l, dim=-1) / rng_s  # range rate m/s
    return Projected(
        means2d=means2d,
        depths=rng,
        conics=conics,
        radii=radii,
        compensations=compensations,
        vel2d=vel2d,
        depth_vel=depth_vel,
    )
