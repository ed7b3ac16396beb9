"""Ray generators: index batches -> ray bundles (torch port of
`neurad_tpu/model_components/ray_generators.py`; nerfstudio's RayGenerator and
LidarRayGenerator), with an optional per-ray pose correction."""

from __future__ import annotations

from typing import Optional

import torch

from neurad_tpu_torch.cameras.cameras import Cameras, generate_rays
from neurad_tpu_torch.cameras.lidars import Lidars, generate_lidar_rays_from_points
from neurad_tpu_torch.core.structs import RayBundle


def ray_generator(cameras: Cameras, ray_indices: torch.Tensor,
                  camera_opt_to_camera: Optional[torch.Tensor] = None) -> RayBundle:
    """Indices [R, 3] (camera, row, col) -> the rays through the pixels' centres."""
    cam_idx = ray_indices[:, 0].long()
    coords = ray_indices[:, 1:].to(torch.float32) + 0.5
    return generate_rays(cameras, cam_idx, coords, camera_opt_to_camera=camera_opt_to_camera)


def lidar_ray_generator(lidars: Lidars, scan_indices: torch.Tensor, points: torch.Tensor,
                        lidar_opt_to_lidar: Optional[torch.Tensor] = None) -> RayBundle:
    """Per-point scan indices [R] and points [R, >= 5] -> the points' rays."""
    return generate_lidar_rays_from_points(lidars, scan_indices.long(), points, lidar_opt_to_lidar=lidar_opt_to_lidar)
