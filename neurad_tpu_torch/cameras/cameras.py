"""Camera containers (torch port of `neurad_tpu/cameras/cameras.py:32-72`).

Only the containers: ray generation waits for the NeuRAD slice. Fields are
host-side tensors; `dataclasses.replace` swaps fields (the JAX pytree's
`.replace`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class CameraType(enum.IntEnum):
    """Supported camera models (AD datasets are all PERSPECTIVE)."""

    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3
    ORTHOPHOTO = 8


@dataclasses.dataclass
class Cameras:
    """A batch of cameras. All per-camera fields are [N, ...] tensors.

    `metadata` holds optional per-camera tensors: `velocities` [N,3],
    `rolling_shutter_time` [N,1], `time_to_center_pixel` [N,1],
    `sensor_idxs` [N,1] int.
    """

    camera_to_worlds: torch.Tensor  # [N, 3, 4] OpenGL convention (x right, y up, -z forward)
    fx: torch.Tensor  # [N, 1]
    fy: torch.Tensor  # [N, 1]
    cx: torch.Tensor  # [N, 1]
    cy: torch.Tensor  # [N, 1]
    width: torch.Tensor  # [N, 1] int32
    height: torch.Tensor  # [N, 1] int32
    camera_type: torch.Tensor  # [N, 1] int32 (CameraType)
    distortion_params: Optional[torch.Tensor] = None  # [N, 6]
    times: Optional[torch.Tensor] = None  # [N, 1]
    metadata: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    def replace(self, **changes) -> "Cameras":
        return dataclasses.replace(self, **changes)
