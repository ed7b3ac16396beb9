"""Camera pose / velocity optimizers (torch port of
`neurad_tpu/cameras/camera_optimizers.py`): learnable per-image 6-dof tangent
deltas, their application to sensor-to-world matrices, their regularisers and
metrics. Applying them to ray bundles arrives with the ray-based models.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from neurad_tpu_torch.core.lie import exp_map_SE3, exp_map_SO3xR3


class CameraOptimizer(nn.Module):
    """Learnable per-camera pose correction. mode: 'off' | 'SO3xR3' | 'SE3'.
    `weights` scales the tangent axes before the exp map;
    `non_trainable_camera_indices` (e.g. eval sensors) get identity corrections."""

    def __init__(
        self,
        num_cameras: int,
        mode: str = "off",
        weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
        trans_l2_penalty: Sequence[float] = (1e-2, 1e-2, 1e-2),
        rot_l2_penalty: float = 1e-3,
        non_trainable_camera_indices: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        if mode not in ("off", "SO3xR3", "SE3"):
            raise ValueError(f"unknown camera optimizer mode {mode}")
        self.mode = mode
        self.rot_l2_penalty = rot_l2_penalty
        self.register_buffer("weights", torch.tensor(weights, dtype=torch.float32), persistent=False)
        self.register_buffer("trans_l2_penalty", torch.tensor(trans_l2_penalty, dtype=torch.float32), persistent=False)
        trainable = torch.ones(num_cameras, 1)
        if non_trainable_camera_indices:
            trainable[list(non_trainable_camera_indices)] = 0.0
        self.register_buffer("trainable", trainable, persistent=False)
        if mode != "off":
            self.pose_adjustment = nn.Parameter(torch.zeros(num_cameras, 6))

    def _adjustment(self) -> torch.Tensor:
        return self.pose_adjustment * self.weights * self.trainable

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """Correction matrices [R, 3, 4] for camera indices [R]."""
        if self.mode == "off":
            eye = torch.eye(4, device=indices.device)[:3, :4]
            return eye.expand(indices.shape + (3, 4))
        adj = self._adjustment()[indices.reshape(-1)]
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

    def regularization_loss(self) -> torch.Tensor:
        """Per-axis translation L1 penalty + rotation norm penalty. The norm's
        gradient at a zero rotation is NaN in the JAX package and zero here
        (torch's subgradient); the two agree wherever the adjustment is not 0."""
        if self.mode == "off":
            return torch.zeros((), device=self.weights.device)
        adj = self._adjustment()
        trans = torch.mean(torch.sum(adj[:, :3].abs() * self.trans_l2_penalty, dim=-1))
        rot = torch.mean(torch.linalg.norm(adj[:, 3:], dim=-1)) * self.rot_l2_penalty
        return trans + rot

    @torch.no_grad()
    def metrics(self) -> Dict[str, torch.Tensor]:
        if self.mode == "off":
            return {}
        adj = self._adjustment()
        trans = torch.linalg.norm(adj[:, :3], dim=-1)
        rot = torch.linalg.norm(adj[:, 3:], dim=-1)
        return {
            "camera_opt_translation_max": trans.max(),
            "camera_opt_translation_mean": trans.mean(),
            "camera_opt_rotation_mean": torch.rad2deg(rot.mean()),
            "camera_opt_rotation_max": torch.rad2deg(rot.max()),
        }


class CameraVelocityOptimizer(nn.Module):
    """Learnable per-image velocity deltas for rolling-shutter compensation."""

    def __init__(
        self,
        num_cameras: int,
        num_unique_cameras: int,
        enabled: bool = False,
        zero_initial_velocities: bool = False,
        linear_l2_penalty: float = 1e-6,
        angular_l2_penalty: float = 1e-5,
    ):
        super().__init__()
        self.enabled = enabled
        self.zero_initial_velocities = zero_initial_velocities
        self.linear_l2_penalty = linear_l2_penalty
        self.angular_l2_penalty = angular_l2_penalty
        if enabled:
            self.linear_velocity_adjustment = nn.Parameter(torch.zeros(num_cameras, 3))
            self.angular_velocity_adjustment = nn.Parameter(torch.zeros(num_cameras, 3))
            self.time_to_center_pixel_adjustment = nn.Parameter(torch.zeros(num_unique_cameras))

    def get_linear_velocity(self, base_velocity: torch.Tensor, camera_idx: torch.Tensor) -> torch.Tensor:
        base = torch.zeros_like(base_velocity) if self.zero_initial_velocities else base_velocity
        if not self.enabled:
            return base
        return base + self.linear_velocity_adjustment[camera_idx]

    def get_angular_velocity(self, base_velocity: torch.Tensor, camera_idx: torch.Tensor) -> torch.Tensor:
        base = torch.zeros_like(base_velocity) if self.zero_initial_velocities else base_velocity
        if not self.enabled:
            return base
        return base + self.angular_velocity_adjustment[camera_idx]

    def get_time_to_center_pixel_adjustment(self, sensor_idx: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return torch.zeros(sensor_idx.shape, dtype=torch.float32, device=sensor_idx.device)
        return self.time_to_center_pixel_adjustment[sensor_idx]

    def regularization_loss(self) -> torch.Tensor:
        if not self.enabled:
            return torch.zeros(())
        lin = torch.mean(torch.sum(self.linear_velocity_adjustment**2, dim=-1)) * self.linear_l2_penalty
        ang = torch.mean(torch.sum(self.angular_velocity_adjustment**2, dim=-1)) * self.angular_l2_penalty
        return lin + ang
