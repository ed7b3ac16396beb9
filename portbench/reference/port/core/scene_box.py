"""Scene boxes (torch port of `neurad_tpu/core/scene_box.py`): the
axis-aligned scene box and an oriented box, with masks of the points inside
(`nerfstudio/data/scene_box.py:30,95`)."""

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

    def within(self, pts: torch.Tensor) -> torch.Tensor:
        """Bool mask [...] of points [..., 3] strictly inside the box (a point
        on a face is outside; `scene_box.py:53-58`)."""
        return torch.all((pts > self.aabb[0]) & (pts < self.aabb[1]), dim=-1)


@dataclasses.dataclass
class OrientedBox:
    """Oriented box: rotation R [3, 3] (its columns the box's axes in the
    world), translation T [3] (its centre), size S [3] (`scene_box.py:95-126`)."""

    R: torch.Tensor
    T: torch.Tensor
    S: torch.Tensor

    def within(self, pts: torch.Tensor) -> torch.Tensor:
        """Bool mask [...] of points [..., 3] strictly inside the box."""
        local = (pts - self.T) @ self.R  # world -> box frame
        half = self.S / 2.0
        return torch.all((local > -half) & (local < half), dim=-1)
