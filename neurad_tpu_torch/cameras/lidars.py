"""Lidar sensor models and point-cloud ray generation (torch port of
`neurad_tpu/cameras/lidars.py`). `generate_lidar_rays_from_points` runs on the
device of `points`: the sensor fields are moved there.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from neurad_tpu_torch.core import poses as pose_utils
from neurad_tpu_torch.core.structs import RayBundle

# Beam divergences in radians.
HORIZONTAL_BEAM_DIVERGENCE = 3.0e-3
VERTICAL_BEAM_DIVERGENCE = 1.5e-3


class LidarType(enum.IntEnum):
    """Supported lidar sensors."""

    VELODYNE16 = 1
    VELODYNE_HDL32E = 2
    VELODYNE64E = 3
    VELODYNE128 = 4
    PANDAR64 = 5
    WOD64 = 6
    WOD_TOP = 7


@dataclasses.dataclass
class Lidars:
    """A batch of lidar sensors. Per-scan fields are [N, ...] tensors.

    `metadata` keys: `velocities` [N,3] (sensor linear velocity, world frame),
    `sensor_idxs` [N,1].
    """

    lidar_to_worlds: torch.Tensor  # [N, 3, 4]
    lidar_type: torch.Tensor  # [N, 1] int32 (LidarType)
    times: Optional[torch.Tensor] = None  # [N, 1]
    horizontal_beam_divergence: Optional[torch.Tensor] = None  # [N, 1] rad
    vertical_beam_divergence: Optional[torch.Tensor] = None  # [N, 1] rad
    valid_lidar_distance_threshold: float = 1e3
    assume_ego_compensated: bool = True
    metadata: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return self.lidar_to_worlds.shape[0]

    def replace(self, **changes) -> "Lidars":
        return dataclasses.replace(self, **changes)


def generate_lidar_rays_from_points(
    lidars: Lidars,
    lidar_indices: torch.Tensor,
    points: torch.Tensor,
    lidar_opt_to_lidar: Optional[torch.Tensor] = None,
) -> RayBundle:
    """A RayBundle whose rays go from each sensor origin through its points:
    per-point ego-motion correction of origins by timediff * sensor velocity,
    `directions_norm` = point range, `is_lidar` / `did_return` metadata flags.

    lidar_indices [R] int indices into the lidar batch (one per point); points
    [R, >=5] columns (x, y, z, intensity, timediff) in the sensor frame;
    lidar_opt_to_lidar optional [R, 3, 4] pose correction."""
    dev = points.device
    idx = lidar_indices.reshape(-1).to(device=dev, dtype=torch.long)
    take = lambda field: field.to(dev)[idx]
    l2w = take(lidars.lidar_to_worlds)  # [R, 3, 4]
    if lidar_opt_to_lidar is not None:
        l2w = pose_utils.multiply(l2w, lidar_opt_to_lidar)

    xyz = points[..., :3]
    points_world = torch.sum(l2w[..., :3, :3] * xyz[:, None, :], dim=-1) + l2w[..., :3, 3]
    origins = l2w[..., :3, 3]

    if points.shape[-1] >= 5 and "velocities" in lidars.metadata:
        vel = take(lidars.metadata["velocities"])  # [R, 3]
        timediff = points[..., 4:5]
        origins = origins + timediff * vel
        if not lidars.assume_ego_compensated:
            points_world = points_world + timediff * vel

    directions = points_world - origins
    distance = torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = directions / distance.clamp_min(1e-12)

    if lidars.horizontal_beam_divergence is not None:
        dx = take(lidars.horizontal_beam_divergence)
    else:
        dx = torch.full((idx.shape[0], 1), HORIZONTAL_BEAM_DIVERGENCE, device=dev)
    if lidars.vertical_beam_divergence is not None:
        dy = take(lidars.vertical_beam_divergence)
    else:
        dy = torch.full((idx.shape[0], 1), VERTICAL_BEAM_DIVERGENCE, device=dev)
    pixel_area = dx * dy

    metadata = {k: take(v) for k, v in lidars.metadata.items()}
    metadata["directions_norm"] = distance
    metadata["is_lidar"] = torch.ones_like(distance, dtype=torch.bool)
    metadata["did_return"] = distance < lidars.valid_lidar_distance_threshold

    times = take(lidars.times) if lidars.times is not None else torch.zeros_like(distance)
    if points.shape[-1] >= 5:
        times = times + points[..., 4:5]

    return RayBundle(
        origins=origins,
        directions=directions,
        pixel_area=pixel_area,
        camera_indices=idx[:, None],
        times=times,
        fars=torch.full_like(pixel_area, 1_000_000.0),
        metadata=metadata,
    )


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Apply one [3, 4] pose to [N, 3] points."""
    return points @ pose[:3, :3].T + pose[:3, 3]


def transform_points_pairwise(points: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Apply per-point [N, 3, 4] poses to [N, 3] points."""
    return torch.sum(poses[..., :3, :3] * points[:, None, :], dim=-1) + poses[..., :3, 3]
