"""Lidar containers (torch port of `neurad_tpu/cameras/lidars.py`).

Only the containers: ray generation from points waits for the NeuRAD slice.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


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
