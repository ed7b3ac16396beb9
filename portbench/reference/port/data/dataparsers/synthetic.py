"""Synthetic AD scene: analytic raytraced cameras + lidar + one moving actor.

Torch port of `neurad_tpu/data/dataparsers/synthetic.py`: the same numpy
raytracer (so the same config gives the same arrays), wrapped in the port's
tensor containers. Scene layout: ego camera driving along +x, lidar on the
roof, world z-up.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from portbench.reference.port.cameras.cameras import CameraType, Cameras
from portbench.reference.port.cameras.lidars import LidarType, Lidars
from portbench.reference.port.core.scene_box import SceneBox
from portbench.reference.port.data.dataparsers.base import ADDataparserOutputs

# OpenGL camera (x right, y up, -z forward) mounted looking along world +x:
# columns = camera axes in world: x_cam (image right) = -y, y_cam (up) = +z,
# z_cam (backward) = -x  ==> the camera faces +x (the driving direction)
_CAM_ROT = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=np.float32)

_SPHERES = np.array(  # (x, y, z, radius)
    [[14.0, -4.0, 1.0, 1.5], [22.0, 5.0, 1.5, 2.0], [33.0, -3.0, 1.0, 1.2], [45.0, 4.0, 2.0, 2.5]],
    dtype=np.float32,
)
_SPHERE_COLORS = np.array(
    [[0.9, 0.2, 0.2], [0.2, 0.7, 0.3], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2]], dtype=np.float32
)
_ACTOR_DIMS = np.array([2.0, 4.0, 2.0], dtype=np.float32)  # wlh
_ACTOR_COLOR = np.array([0.9, 0.5, 0.1], dtype=np.float32)
_GROUND_A = np.array([0.35, 0.35, 0.35], dtype=np.float32)
_GROUND_B = np.array([0.55, 0.55, 0.55], dtype=np.float32)
_SKY = np.array([0.6, 0.75, 0.95], dtype=np.float32)


def _actor_center(t: np.ndarray) -> np.ndarray:
    """Actor drives along +x at 3 m/s in the y=+2 lane."""
    c = np.zeros(t.shape + (3,), dtype=np.float32)
    c[..., 0] = 8.0 + 3.0 * t
    c[..., 1] = 2.0
    c[..., 2] = _ACTOR_DIMS[2] / 2.0
    return c


def _trace(origins: np.ndarray, dirs: np.ndarray, t: float) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic raytrace -> (rgb [N,3], depth [N]); depth=inf for sky."""
    with np.errstate(invalid="ignore", over="ignore"):
        n = origins.shape[0]
        depth = np.full(n, np.inf, dtype=np.float32)
        rgb = np.tile(_SKY, (n, 1))

        # ground plane z=0
        dz = dirs[:, 2]
        tg = np.where(dz < -1e-6, -origins[:, 2] / np.where(np.abs(dz) > 1e-6, dz, 1.0), np.inf)
        hitg = tg < depth
        px = origins[:, 0] + tg * dirs[:, 0]
        py = origins[:, 1] + tg * dirs[:, 1]
        checker = ((np.floor(px / 4.0) + np.floor(py / 4.0)) % 2).astype(bool)
        gcol = np.where(checker[:, None], _GROUND_A, _GROUND_B)
        depth = np.where(hitg, tg, depth)
        rgb = np.where(hitg[:, None], gcol, rgb)

        for (cx, cy, cz, r), col in zip(_SPHERES, _SPHERE_COLORS):
            oc = origins - np.array([cx, cy, cz])
            b = np.sum(oc * dirs, axis=-1)
            c = np.sum(oc * oc, axis=-1) - r * r
            disc = b * b - c
            ts = np.where(disc > 0, -b - np.sqrt(np.clip(disc, 0, None)), np.inf)
            hit = (ts > 1e-3) & (ts < depth)
            depth = np.where(hit, ts, depth)
            rgb = np.where(hit[:, None], col, rgb)

        # actor box (axis-aligned since it never rotates)
        center = _actor_center(np.asarray(t))
        half = _ACTOR_DIMS[[1, 0, 2]] / 2.0  # length along x, width along y
        lo, hi = center - half, center + half
        inv = 1.0 / np.where(np.abs(dirs) > 1e-9, dirs, 1e-9)
        t0 = (lo - origins) * inv
        t1 = (hi - origins) * inv
        tmin = np.minimum(t0, t1).max(axis=-1)
        tmax = np.maximum(t0, t1).min(axis=-1)
        hit = (tmax > tmin) & (tmin > 1e-3) & (tmin < depth)
        depth = np.where(hit, tmin, depth)
        rgb = np.where(hit[:, None], _ACTOR_COLOR, rgb)
    return rgb, depth


@dataclasses.dataclass
class SyntheticDataParserConfig:
    """Scene/sensor rig parameters."""

    num_frames: int = 10
    duration: float = 5.0
    image_height: int = 48
    image_width: int = 72
    focal: float = 40.0
    lidar_channels: int = 16
    lidar_azimuths: int = 180
    lidar_max_range: float = 60.0
    train_split_fraction: float = 0.8
    seed: int = 0

    def setup(self) -> "SyntheticDataParser":
        return SyntheticDataParser(self)


class SyntheticDataParser:
    """Generates the synthetic sequence (ADDataParser's output contract)."""

    def __init__(self, config: SyntheticDataParserConfig):
        self.config = config

    def get_dataparser_outputs(self, split: str = "train") -> ADDataparserOutputs:
        cfg = self.config
        times = np.linspace(0.0, cfg.duration, cfg.num_frames).astype(np.float32)
        ego_x = 2.0 * times  # ego drives +x at 2 m/s

        h, w, f = cfg.image_height, cfg.image_width, cfg.focal
        n = cfg.num_frames

        c2w = np.zeros((n, 3, 4), dtype=np.float32)
        c2w[:, :3, :3] = _CAM_ROT
        c2w[:, 0, 3] = ego_x
        c2w[:, 2, 3] = 1.6  # camera height
        cam_vel = np.zeros((n, 3), dtype=np.float32)
        cam_vel[:, 0] = 2.0

        cameras = Cameras(
            camera_to_worlds=torch.from_numpy(c2w),
            fx=torch.full((n, 1), float(f)),
            fy=torch.full((n, 1), float(f)),
            cx=torch.full((n, 1), w / 2.0),
            cy=torch.full((n, 1), h / 2.0),
            width=torch.full((n, 1), w, dtype=torch.int32),
            height=torch.full((n, 1), h, dtype=torch.int32),
            camera_type=torch.full((n, 1), int(CameraType.PERSPECTIVE), dtype=torch.int32),
            times=torch.from_numpy(times)[:, None],
            metadata={"sensor_idxs": torch.zeros((n, 1), dtype=torch.int32)},
        )

        ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
        cam_dirs = np.stack(
            [(xs - w / 2.0) / f, -(ys - h / 2.0) / f, -np.ones_like(xs)], axis=-1
        ).reshape(-1, 3)
        cam_dirs /= np.linalg.norm(cam_dirs, axis=-1, keepdims=True)
        images = []
        for i in range(n):
            dirs_w = cam_dirs @ c2w[i, :3, :3].T
            orig = np.tile(c2w[i, :3, 3], (dirs_w.shape[0], 1))
            rgb, _ = _trace(orig, dirs_w, times[i])
            images.append(rgb.reshape(h, w, 3).astype(np.float32))

        l2w = np.zeros((n, 3, 4), dtype=np.float32)
        l2w[:, :3, :3] = np.eye(3)
        l2w[:, 0, 3] = ego_x
        l2w[:, 2, 3] = 2.0  # roof lidar
        elevs = np.deg2rad(np.linspace(-15.0, 5.0, cfg.lidar_channels))
        azims = np.linspace(-np.pi, np.pi, cfg.lidar_azimuths, endpoint=False)
        el, az = np.meshgrid(elevs, azims, indexing="ij")
        ldirs = np.stack(
            [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
        ).reshape(-1, 3)
        point_clouds = []
        for i in range(n):
            orig = np.tile(l2w[i, :3, 3], (ldirs.shape[0], 1))
            rgb, depth = _trace(orig, ldirs, times[i])
            ret = np.isfinite(depth) & (depth < cfg.lidar_max_range)
            pts = ldirs[ret] * depth[ret, None]  # sensor frame == world-aligned here
            intensity = rgb[ret].mean(-1, keepdims=True)
            timediff = np.zeros_like(intensity)
            point_clouds.append(
                np.concatenate([pts, intensity, timediff], axis=-1).astype(np.float32)
            )

        lidars = Lidars(
            lidar_to_worlds=torch.from_numpy(l2w),
            lidar_type=torch.full((n, 1), int(LidarType.VELODYNE16), dtype=torch.int32),
            times=torch.from_numpy(times)[:, None],
            metadata={
                "velocities": torch.from_numpy(cam_vel),
                "sensor_idxs": torch.ones((n, 1), dtype=torch.int32),
            },
        )

        actor_poses = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
        actor_poses[:, :3, 3] = _actor_center(times)
        trajectories = [
            {
                "poses": actor_poses,
                "timestamps": times,
                "dims": _ACTOR_DIMS,
                "symmetric": True,
                "deformable": False,
                "linear_velocities_global": np.tile(np.array([3.0, 0.0, 0.0], dtype=np.float32), (n, 1)),
                "angular_velocities_local": np.zeros((n, 3), dtype=np.float32),
            }
        ]

        n_eval = max(1, int(n * (1 - cfg.train_split_fraction)))
        eval_idx = tuple(range(n - n_eval, n))

        aabb = np.array([[-10.0, -20.0, -1.0], [60.0, 20.0, 10.0]], dtype=np.float32)
        return ADDataparserOutputs(
            cameras=cameras,
            images=images,
            lidars=lidars,
            point_clouds=point_clouds,
            scene_box=SceneBox(aabb=torch.from_numpy(aabb)),
            trajectories=trajectories,
            duration=float(cfg.duration),
            sensor_idx_to_name={0: "front_camera", 1: "roof_lidar"},
            eval_camera_indices=eval_idx,
            eval_lidar_indices=eval_idx,
        )
