"""Scene bounding box (torch port of `neurad_tpu/core/scene_box.py`)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SceneBox:
    """Axis-aligned scene box. `aabb`: [2, 3] = [(min xyz), (max xyz)]."""

    aabb: torch.Tensor

    def get_diagonal_length(self) -> torch.Tensor:
        return torch.linalg.norm(self.aabb[1] - self.aabb[0])

    def get_center(self) -> torch.Tensor:
        return (self.aabb[0] + self.aabb[1]) / 2.0

    @staticmethod
    def get_normalized_positions(positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
        """Positions mapped into [0, 1]^3 by the box [2, 3]."""
        return (positions - aabb[0]) / (aabb[1] - aabb[0])
