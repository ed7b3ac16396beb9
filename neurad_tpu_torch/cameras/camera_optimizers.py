"""Camera pose / velocity optimizers (torch port of
`neurad_tpu/cameras/camera_optimizers.py`): the forward corrections the
serving path applies. Their regularisers and training wait for slice 2.
"""

from __future__ import annotations

import torch
from torch import nn

from neurad_tpu_torch.core.lie import exp_map_SE3, exp_map_SO3xR3


class CameraOptimizer(nn.Module):
    """Learnable per-camera pose correction. mode: 'off' | 'SO3xR3' | 'SE3'.
    (The JAX module's axis weights and non-trainable cameras are training
    options; they wait for slice 2.)"""

    def __init__(self, num_cameras: int, mode: str = "off"):
        super().__init__()
        if mode not in ("off", "SO3xR3", "SE3"):
            raise ValueError(f"unknown camera optimizer mode {mode}")
        self.mode = mode
        if mode != "off":
            self.pose_adjustment = nn.Parameter(torch.zeros(num_cameras, 6))

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """Correction matrices [R, 3, 4] for camera indices [R]."""
        if self.mode == "off":
            eye = torch.eye(4, device=indices.device)[:3, :4]
            return eye.expand(indices.shape + (3, 4))
        adj = self.pose_adjustment[indices.reshape(-1)]
        return exp_map_SO3xR3(adj) if self.mode == "SO3xR3" else exp_map_SE3(adj)

    def apply_to_camera_pose(self, sensor_to_world: torch.Tensor, camera_idx: torch.Tensor) -> torch.Tensor:
        """Correct a [.., 3, 4] sensor-to-world matrix: rotation applied to the
        world-frame axes, translation added independently."""
        if self.mode == "off":
            return sensor_to_world
        adj = self(torch.atleast_1d(camera_idx))
        rot = adj[..., :3, :3] @ sensor_to_world[..., :3, :3]
        trans = sensor_to_world[..., :3, 3:] + adj[..., :3, 3:]
        return torch.cat([rot, trans], dim=-1)


class CameraVelocityOptimizer(nn.Module):
    """Learnable per-image velocity deltas for rolling-shutter compensation."""

    def __init__(self, num_cameras: int, num_unique_cameras: int, enabled: bool = False):
        super().__init__()
        self.enabled = enabled
        if enabled:
            self.linear_velocity_adjustment = nn.Parameter(torch.zeros(num_cameras, 3))
            self.angular_velocity_adjustment = nn.Parameter(torch.zeros(num_cameras, 3))
            self.time_to_center_pixel_adjustment = nn.Parameter(torch.zeros(num_unique_cameras))

    def get_linear_velocity(self, base_velocity: torch.Tensor, camera_idx: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return base_velocity
        return base_velocity + self.linear_velocity_adjustment[camera_idx]

    def get_angular_velocity(self, base_velocity: torch.Tensor, camera_idx: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return base_velocity
        return base_velocity + self.angular_velocity_adjustment[camera_idx]

    def get_time_to_center_pixel_adjustment(self, sensor_idx: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return torch.zeros(sensor_idx.shape, dtype=torch.float32, device=sensor_idx.device)
        return self.time_to_center_pixel_adjustment[sensor_idx]
