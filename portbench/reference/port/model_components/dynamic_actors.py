"""Dynamic actor trajectories (torch port of
`neurad_tpu/model_components/dynamic_actors.py`).

Static trajectory data (timestamps, presence mask, sizes, flags) is numpy on
the host and becomes buffers; the positions/rotations(6d)/velocities are
parameters initialised from that data.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from portbench.reference.port.core import poses as pose_utils


@dataclasses.dataclass(frozen=True)
class ActorData:
    """Immutable trajectory data extracted from a dataparser (numpy, host-side)."""

    unique_timestamps: np.ndarray  # [T] sorted
    poses: np.ndarray  # [T, A, 4, 4]
    present: np.ndarray  # [T, A] bool
    sizes: np.ndarray  # [A, 3] wlh
    symmetric: np.ndarray  # [A] bool
    deformable: np.ndarray  # [A] bool
    vel_linear: np.ndarray  # [T, A, 3]
    vel_angular: np.ndarray  # [T, A, 3]

    @property
    def n_actors(self) -> int:
        return self.poses.shape[1]

    @property
    def n_times(self) -> int:
        return self.poses.shape[0]


def actor_data_from_trajectories(trajectories: List[dict]) -> ActorData:
    """Build ActorData from dataparser trajectory dicts.

    Each dict: {poses [Ti,4,4], timestamps [Ti], dims [3], symmetric, deformable,
    optional linear_velocities_global / angular_velocities_local [Ti,3]}.
    Missing timestamps are filled with the nearest pose (marked not-present).
    """
    all_ts = sorted({float(t) for traj in trajectories for t in np.asarray(traj["timestamps"]).reshape(-1)})
    unique_timestamps = np.asarray(all_ts, dtype=np.float64)
    n_times, n_actors = len(unique_timestamps), len(trajectories)

    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (n_times, n_actors, 4, 4)).copy()
    present = np.zeros((n_times, n_actors), dtype=bool)
    sizes = np.zeros((n_actors, 3), dtype=np.float32)
    symmetric = np.zeros((n_actors,), dtype=bool)
    deformable = np.zeros((n_actors,), dtype=bool)
    vel_linear = np.zeros((n_times, n_actors, 3), dtype=np.float32)
    vel_angular = np.zeros((n_times, n_actors, 3), dtype=np.float32)

    for a, traj in enumerate(trajectories):
        sizes[a] = np.asarray(traj["dims"], dtype=np.float32)
        symmetric[a] = bool(traj["symmetric"])
        deformable[a] = bool(traj["deformable"])
        traj_ts = np.asarray(traj["timestamps"], dtype=np.float64).reshape(-1)
        traj_poses = np.asarray(traj["poses"], dtype=np.float32)
        for ti, t in enumerate(unique_timestamps):
            diff = np.abs(traj_ts - t)
            j = int(diff.argmin())
            poses[ti, a] = traj_poses[j]
            if diff[j] < 1e-4:
                present[ti, a] = True
                if "linear_velocities_global" in traj:
                    vel_linear[ti, a] = np.asarray(traj["linear_velocities_global"])[j, :3]
                if "angular_velocities_local" in traj:
                    vel_angular[ti, a] = np.asarray(traj["angular_velocities_local"])[j, :3]

    return ActorData(
        unique_timestamps=unique_timestamps,
        poses=poses,
        present=present,
        sizes=sizes,
        symmetric=symmetric,
        deformable=deformable,
        vel_linear=vel_linear,
        vel_angular=vel_angular,
    )


def empty_actor_data() -> ActorData:
    """Zero-actor placeholder (static scenes)."""
    return ActorData(
        unique_timestamps=np.array([0.0, 1.0]),
        poses=np.broadcast_to(np.eye(4, dtype=np.float32), (2, 0, 4, 4)).copy(),
        present=np.zeros((2, 0), dtype=bool),
        sizes=np.zeros((0, 3), dtype=np.float32),
        symmetric=np.zeros((0,), dtype=bool),
        deformable=np.zeros((0,), dtype=bool),
        vel_linear=np.zeros((2, 0, 3), dtype=np.float32),
        vel_angular=np.zeros((2, 0, 3), dtype=np.float32),
    )


@dataclasses.dataclass(frozen=True)
class ActorEdits:
    """Actor edits applied at render time: shifts in the box frame and a yaw.
    Values are floats or 0-d tensors; `index` -1 edits every actor."""

    lateral: float = 0.0
    longitudinal: float = 0.0
    rotation: float = 0.0
    height: float = 0.0
    index: int = -1


def edit_boxes2world(boxes2world: torch.Tensor, edits: ActorEdits, n_actors: int) -> torch.Tensor:
    """Apply lateral/longitudinal/height shifts (box frame) + yaw rotation to
    [Q, A, 4, 4] boxes."""
    vals = (edits.lateral, edits.longitudinal, edits.rotation, edits.height)
    static_vals = all(isinstance(v, (int, float)) for v in vals)
    if static_vals and all(v == 0.0 for v in vals):
        return boxes2world
    dev, dt = boxes2world.device, boxes2world.dtype
    sel = torch.ones((n_actors,), dtype=torch.bool, device=dev)
    if edits.index >= 0:
        sel = torch.zeros((n_actors,), dtype=torch.bool, device=dev)
        sel[min(edits.index, n_actors - 1)] = True

    shift = torch.stack(
        [torch.as_tensor(v, dtype=dt, device=dev) for v in (edits.lateral, edits.longitudinal, edits.height, 1.0)]
    )
    new_t = boxes2world @ shift  # [Q, A, 4]
    out = boxes2world.clone()
    out[..., 3] = torch.where(sel[None, :, None], new_t, boxes2world[..., 3])

    if not (static_vals and edits.rotation == 0.0):
        rot = torch.as_tensor(edits.rotation, dtype=dt, device=dev)
        c, s = torch.cos(rot), torch.sin(rot)
        zero, one = torch.zeros((), dtype=dt, device=dev), torch.ones((), dtype=dt, device=dev)
        yaw = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]), torch.stack([zero, zero, one])])
        rotated = torch.einsum("ij,qajk->qaik", yaw, out[..., :3, :3])
        out[..., :3, :3] = torch.where(sel[None, :, None, None], rotated, out[..., :3, :3])
    return out


class DynamicActors(nn.Module):
    """Learnable actor trajectories. Parameters (initialised from `data`):
    `actor_positions` [T,A,3], `actor_rotations_6d` [T,A,6],
    `actor_vel_linear` / `actor_vel_angular` [T,A,3]. Without
    `optimize_trajectories` the poses come from `data` and the pose
    parameters get no gradient (they exist all the same, as in the JAX
    package)."""

    def __init__(self, data: ActorData, actor_bbox_padding: Tuple[float, float, float] = (0.25, 0.25, 0.1),
                 optimize_trajectories: bool = True):
        super().__init__()
        self.data = data
        self.optimize_trajectories = optimize_trajectories
        bounds = np.asarray(data.sizes, dtype=np.float32) / 2.0 + np.asarray(actor_bbox_padding, dtype=np.float32)
        self.register_buffer("bounds", torch.from_numpy(bounds), persistent=False)
        poses = torch.from_numpy(np.asarray(data.poses, dtype=np.float32))
        self.actor_positions = nn.Parameter(poses[..., :3, 3].clone())
        self.actor_rotations_6d = nn.Parameter(pose_utils.rotmat_to_6d(poses[..., :3, :3]))
        self.actor_vel_linear = nn.Parameter(torch.from_numpy(np.asarray(data.vel_linear, dtype=np.float32)))
        self.actor_vel_angular = nn.Parameter(torch.from_numpy(np.asarray(data.vel_angular, dtype=np.float32)))
        self.register_buffer(
            "unique_timestamps", torch.from_numpy(np.asarray(data.unique_timestamps, dtype=np.float32)), persistent=False
        )
        self.register_buffer("present", torch.from_numpy(np.asarray(data.present)), persistent=False)

    @property
    def n_actors(self) -> int:
        return self.data.n_actors

    def actor_bounds(self) -> torch.Tensor:
        """Half-sizes + padding [A, 3]."""
        return self.bounds

    def forward(self, query_times: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.get_boxes2world(query_times)

    def get_boxes2world(
        self, query_times: torch.Tensor, edits: Optional[ActorEdits] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """6D-interpolated actor poses at query times [Q] ->
        (boxes2world [Q, A, 4, 4], valid [Q, A])."""
        pos, rot6d = self.actor_positions, self.actor_rotations_6d
        if not self.optimize_trajectories:
            poses = torch.from_numpy(np.asarray(self.data.poses, dtype=np.float32)).to(pos.device)
            pos, rot6d = poses[..., :3, 3], pose_utils.rotmat_to_6d(poses[..., :3, :3])
        poses9d = torch.cat([rot6d, pos], dim=-1)  # [T, A, 9]
        interp, valid = pose_utils.interpolate_trajectories_6d(
            poses9d.transpose(0, 1), self.unique_timestamps, query_times, pose_valid_mask=self.present
        )  # [Q, A, 9]
        rot = pose_utils.rot6d_to_rotmat(interp[..., :6])
        boxes2world = pose_utils.to4x4(torch.cat([rot, interp[..., 6:9, None]], dim=-1))
        if edits is not None and self.n_actors > 0:
            boxes2world = edit_boxes2world(boxes2world, edits, self.n_actors)
        return boxes2world, valid

    def get_velocities(self, query_times: torch.Tensor) -> torch.Tensor:
        """Lerped (linear, angular) velocities [Q, A, 6]."""
        vels = torch.cat([self.actor_vel_linear, self.actor_vel_angular], dim=-1)
        return pose_utils.interpolate_velocities(vels, self.unique_timestamps, query_times)
