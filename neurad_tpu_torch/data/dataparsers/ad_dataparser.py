"""AD dataparser base: the template-method pipeline every dataset parser shares
(torch port of `neurad_tpu/data/dataparsers/ad_dataparser.py`).

The pipeline is host-side numpy, as in the JAX package; its result holds the
port's containers (`Cameras`, `Lidars`, `SceneBox`) of CPU tensors, as
`data/dataparsers/synthetic.py` builds them. Subclasses implement
`_get_cameras`, `_get_lidars`, `_read_lidars`, `_read_images` and
`_get_actor_trajectories`. Actor tracks are resampled at the lidar times by
slerp in float32 (`core/poses.interpolate_trajectories`); missing lidar
returns are synthesised from the sensor's beam table (`_add_missing_points`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from neurad_tpu_torch.cameras.cameras import CameraType, Cameras
from neurad_tpu_torch.cameras.lidars import LidarType, Lidars
from neurad_tpu_torch.core import poses as tpose
from neurad_tpu_torch.core.scene_box import SceneBox
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs

DUMMY_DISTANCE_VALUE = 2e3  # missing-point fill distance (`ad_dataparser.py:52`)

# OpenCV camera (x right, y down, z forward) -> nerfstudio/OpenGL (x right, y up, -z forward)
OPENCV_TO_OPENGL = np.array(
    [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], dtype=np.float32
)


def _np_pose_inverse(pose: np.ndarray) -> np.ndarray:
    r_inv = np.swapaxes(pose[..., :3, :3], -1, -2)
    t_inv = -(r_inv @ pose[..., :3, 3:])
    return np.concatenate([r_inv, t_inv], axis=-1)


def _np_pose_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    r = a[..., :3, :3] @ b[..., :3, :3]
    t = a[..., :3, :3] @ b[..., :3, 3:] + a[..., :3, 3:]
    return np.concatenate([r, t], axis=-1)


def _quat_to_rotmat(w, x, y, z) -> np.ndarray:
    """Rotation matrix of the quaternion (w, x, y, z), normalised first."""
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _rotation_difference(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """Axis-angle of r1->r2 (`utils/poses.py:221-249`), numpy."""
    r_rel = np.swapaxes(r1, -2, -1) @ r2
    trace = np.trace(r_rel, axis1=-2, axis2=-1)
    theta = np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0))
    axis = np.stack(
        [
            r_rel[..., 2, 1] - r_rel[..., 1, 2],
            r_rel[..., 0, 2] - r_rel[..., 2, 0],
            r_rel[..., 1, 0] - r_rel[..., 0, 1],
        ],
        axis=-1,
    )
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / np.clip(norm, 1e-8, None)
    return theta[..., None] * axis


def mean_pose_from_trajectory(trajectory: np.ndarray) -> np.ndarray:
    """Mean pose aligned with driving direction (`ad_dataparser.py:613-635`)."""
    mean_position = trajectory.mean(axis=0)
    directions = np.diff(trajectory, axis=0)
    mean_direction = directions.mean(axis=0)
    mean_direction = mean_direction / np.linalg.norm(mean_direction)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(mean_direction, up)
    up = np.cross(right, mean_direction)
    right /= np.linalg.norm(right)
    up /= np.linalg.norm(up)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = mean_direction
    pose[:3, 2] = up
    pose[:3, 3] = mean_position
    return pose


def world_to_mean_transform(poses: np.ndarray, sensor_idxs: np.ndarray) -> np.ndarray:
    """[3,4] world-recentering transform from the first sensor's trajectory
    (`ad_dataparser.py:649-663`)."""
    sel = sensor_idxs == sensor_idxs[0]
    select_poses = poses[sel]
    trajectory = select_poses[:, :3, 3]
    if trajectory.std(axis=0).max() < 1e-1:
        m2w = np.eye(4, dtype=np.float64)
        m2w[:3, :4] = select_poses[0]
    else:
        m2w = mean_pose_from_trajectory(trajectory)
    return np.linalg.inv(m2w)[:3].astype(np.float32)


def linspaced_split_indices(
    sensor_idxs: np.ndarray, train_split_fraction: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sensor linspaced train/eval split (`ad_dataparser.py:332-356`)."""
    if sensor_idxs.size == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if train_split_fraction == 1.0:
        idx = np.arange(sensor_idxs.size, dtype=np.int64)
        return idx, idx.copy()
    train: List[int] = []
    for s in np.unique(sensor_idxs):
        sample_idxs = np.nonzero(sensor_idxs == s)[0]
        n_train = math.ceil(len(sample_idxs) * train_split_fraction)
        sel = np.linspace(0, len(sample_idxs) - 1, n_train, dtype=np.int64)
        train += sample_idxs[sel].tolist()
    train_arr = np.asarray(sorted(train), dtype=np.int64)
    eval_arr = np.setdiff1d(np.arange(sensor_idxs.size), train_arr)
    return train_arr, eval_arr


def sensor_velocities(poses: np.ndarray, times: np.ndarray, sensor_idxs: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-frame (world-linear, local-linear, local-angular) velocities by
    finite differences within each sensor (`ad_dataparser.py:358-406`)."""
    n = poses.shape[0]
    vel = np.zeros((n, 3), dtype=np.float32)
    vel_local = np.zeros((n, 3), dtype=np.float32)
    ang_local = np.zeros((n, 3), dtype=np.float32)
    for s in np.unique(sensor_idxs):
        m = sensor_idxs == s
        p, t = poses[m], times[m].reshape(-1, 1)
        if p.shape[0] < 2:
            continue
        dt = t[1:] - t[:-1]
        trans = (p[1:, :3, 3] - p[:-1, :3, 3]) / dt
        next_in_prev = _np_pose_multiply(_np_pose_inverse(p[:-1]), p[1:])
        trans_local = next_in_prev[:, :3, 3] / dt
        ang = _rotation_difference(p[:-1, :3, :3], p[1:, :3, :3]) / dt
        vel[m] = np.concatenate([trans, trans[-1:]], axis=0)
        vel_local[m] = np.concatenate([trans_local, trans_local[-1:]], axis=0)
        ang_local[m] = np.concatenate([ang, ang[-1:]], axis=0)
    return {"velocities": vel, "linear_velocities_local": vel_local, "angular_velocities_local": ang_local}


def interpolate_trajectory_dicts(
    trajectories: List[dict], timestamps: np.ndarray, extrapolation_length: float = 1.0
) -> List[dict]:
    """Resample actor trajectories at the sensor times within
    `extrapolation_length` of each track's ends (slerp of the rotations, lerp
    of the positions, float32, extrapolating beyond the ends); tracks that
    meet fewer than two sensor times are dropped."""
    timestamps = np.sort(timestamps)
    out = []
    for traj in trajectories:
        ts = np.asarray(traj["timestamps"], dtype=np.float64).reshape(-1)
        q = timestamps[(timestamps >= ts[0] - extrapolation_length) & (timestamps <= ts[-1] + extrapolation_length)]
        if q.size < 2:
            continue
        poses34 = np.asarray(traj["poses"], dtype=np.float32)[:, :3, :4]
        interp = tpose.interpolate_trajectories(
            torch.from_numpy(poses34)[:, None], torch.from_numpy(ts.astype(np.float32)),
            torch.from_numpy(q.astype(np.float32)), clamp_frac=False,
        )
        new_poses = np.zeros((q.size, 4, 4), dtype=np.float32)
        new_poses[:, 3, 3] = 1.0
        new_poses[:, :3, :4] = interp[:, 0].numpy()
        new_traj = dict(traj)
        new_traj["poses"] = new_poses
        new_traj["timestamps"] = q.astype(np.float32)
        out.append(new_traj)
    return out


def add_trajectory_velocities(trajectories: List[dict]) -> List[dict]:
    """Finite-difference actor velocities (`ad_dataparser.py:425-444`)."""
    for traj in trajectories:
        p = np.asarray(traj["poses"])[:, :3]
        t = np.asarray(traj["timestamps"]).reshape(-1, 1)
        if p.shape[0] < 2:
            traj["linear_velocities_global"] = np.zeros((p.shape[0], 3), dtype=np.float32)
            traj["angular_velocities_local"] = np.zeros((p.shape[0], 3), dtype=np.float32)
            continue
        dt = np.clip(t[1:] - t[:-1], 1e-6, None)
        lin = (p[1:, :3, 3] - p[:-1, :3, 3]) / dt
        ang = _rotation_difference(p[:-1, :3, :3], p[1:, :3, :3]) / dt
        traj["linear_velocities_global"] = np.concatenate([lin, lin[-1:]], axis=0).astype(np.float32)
        traj["angular_velocities_local"] = np.concatenate([ang, ang[-1:]], axis=0).astype(np.float32)
    return trajectories


@dataclasses.dataclass
class ADDataParserConfig:
    """Shared AD parser options (`ad_dataparser.py:56-125`)."""

    data: str = "data"
    sequence: str = "001"
    cameras: Tuple[str, ...] = ("front",)
    lidars: Tuple[str, ...] = ("lidar",)
    load_cuboids: bool = True
    dataset_start_fraction: float = 0.0
    dataset_end_fraction: float = 1.0
    train_split_fraction: float = 0.5
    min_lidar_dist: Tuple[float, float, float] = (1.0, 2.0, 2.0)
    scene_box_height: Tuple[float, float] = (-10.0, 30.0)
    trajectory_extrapolation_length: float = 1.0
    rolling_shutter_time: float = 0.0
    time_to_center_pixel: float = 0.0
    add_missing_points: bool = False
    allow_per_point_times: bool = True
    max_eval_frames: Optional[int] = None


class ADDataParser:
    """Template-method AD parser (`ad_dataparser.py:127-244`). Subclasses return
    host-side numpy in the hooks; this class runs the shared pipeline."""

    config: ADDataParserConfig

    def __init__(self, config: ADDataParserConfig):
        self.config = config

    # ---- subclass hooks (`ad_dataparser.py:138-162`) ----
    def _get_cameras(self) -> Tuple[dict, List]:
        """-> (cameras dict {poses [N,3,4], fx, fy, cx, cy, width, height, times,
        sensor_idxs, distortion?}, image filenames/arrays)."""
        raise NotImplementedError

    def _get_lidars(self) -> Tuple[dict, List]:
        """-> (lidars dict {poses [N,3,4], times, sensor_idxs}, pc filepaths)."""
        raise NotImplementedError

    def _read_lidars(self, lidars: dict, filepaths: List) -> List[np.ndarray]:
        raise NotImplementedError

    def _read_images(self, filenames: List) -> List[np.ndarray]:
        raise NotImplementedError

    def _get_actor_trajectories(self) -> List[dict]:
        raise NotImplementedError

    def _get_lane_shift_sign(self, sequence: str) -> int:
        return 1

    # ---- pipeline ----

    def get_dataparser_outputs(self, split: str = "train") -> ADDataparserOutputs:
        cfg = self.config
        cams, img_files = self._get_cameras()
        lids, pc_files = self._get_lidars()
        trajectories = self._get_actor_trajectories() if cfg.load_cuboids else []

        # time filter (`ad_dataparser.py:270-300`)
        all_times = np.concatenate([cams["times"], lids["times"]])
        t0, t1 = all_times.min(), all_times.max()
        dur = t1 - t0
        lo = t0 + dur * cfg.dataset_start_fraction
        hi = t0 + dur * cfg.dataset_end_fraction
        cam_keep = (cams["times"] >= lo) & (cams["times"] <= hi)
        lid_keep = (lids["times"] >= lo) & (lids["times"] <= hi)
        cams = {k: v[cam_keep] for k, v in cams.items()}
        img_files = [f for f, k in zip(img_files, cam_keep) if k]
        lids = {k: v[lid_keep] for k, v in lids.items()}
        pc_files = [f for f, k in zip(pc_files, lid_keep) if k]
        trajectories = [
            t for t in trajectories
            if (np.asarray(t["timestamps"]) >= lo).any() and (np.asarray(t["timestamps"]) <= hi).any()
        ]

        point_clouds = self._read_lidars(lids, pc_files)

        # remove ego points (`ad_dataparser.py:264-268`)
        thr = np.asarray(cfg.min_lidar_dist)
        point_clouds = [pc[(np.abs(pc[:, :3]) >= thr).any(-1)] for pc in point_clouds]

        # zero-base times (`ad_dataparser.py:301-316`)
        min_time = min(cams["times"].min(), lids["times"].min())
        cams["times"] = (cams["times"] - min_time).astype(np.float32)
        lids["times"] = (lids["times"] - min_time).astype(np.float32)
        for traj in trajectories:
            traj["timestamps"] = (np.asarray(traj["timestamps"]) - min_time).astype(np.float32)
        if not cfg.allow_per_point_times:
            for pc in point_clouds:
                if pc.shape[1] > 4:
                    pc[:, 4] = 0.0

        # recenter world (`ad_dataparser.py:316-323`)
        w2m = world_to_mean_transform(lids["poses"], lids["sensor_idxs"].reshape(-1))
        cams["poses"] = _np_pose_multiply(w2m, cams["poses"])
        lids["poses"] = _np_pose_multiply(w2m, lids["poses"])
        for traj in trajectories:
            p = np.asarray(traj["poses"], dtype=np.float32)
            p34 = _np_pose_multiply(w2m, p[:, :3, :4])
            p[:, :3, :4] = p34
            traj["poses"] = p

        # scene box (`ad_dataparser.py:246-261`)
        pad = np.array([[-80.0, 0, 0], [80.0, 0, 0], [0, -60.0, 0], [0, 60.0, 0]], dtype=np.float32)
        l2w = lids["poses"]
        pad_world = (l2w[:, None, :3, :3] @ pad[None, :, :, None])[..., 0] + l2w[:, None, :3, 3]
        pts = np.concatenate([pad_world.reshape(-1, 3), l2w[:, :3, 3]])
        aabb_scale = np.abs(pts).max(axis=0)
        aabb = np.stack([-aabb_scale, aabb_scale])
        aabb[0, 2], aabb[1, 2] = cfg.scene_box_height

        # velocities (`ad_dataparser.py:358-406`)
        cam_vel = sensor_velocities(cams["poses"], cams["times"], cams["sensor_idxs"].reshape(-1))
        lid_vel = sensor_velocities(lids["poses"], lids["times"], lids["sensor_idxs"].reshape(-1))

        # non-overlapping sensor idxs (`ad_dataparser.py:198-203`)
        n_cam_sensors = len(np.unique(cams["sensor_idxs"]))
        lid_sensor_idxs = lids["sensor_idxs"] + n_cam_sensors
        sensor_idx_to_name = {i: n for i, n in enumerate(list(cfg.cameras) + list(cfg.lidars))}

        # train/eval split (`ad_dataparser.py:205-210`)
        cam_train, cam_eval = linspaced_split_indices(cams["sensor_idxs"].reshape(-1), cfg.train_split_fraction)
        lid_train, lid_eval = linspaced_split_indices(lids["sensor_idxs"].reshape(-1), cfg.train_split_fraction)

        # actor trajectories at lidar times (`ad_dataparser.py:212-222`)
        sensor_times = np.unique(lids["times"].reshape(-1))
        trajectories = interpolate_trajectory_dicts(
            trajectories, sensor_times, cfg.trajectory_extrapolation_length
        )
        trajectories = add_trajectory_velocities(trajectories)
        trajectories = [t for t in trajectories if len(t["timestamps"]) > 1]

        if cfg.add_missing_points:
            point_clouds = self._add_missing_points(lids, point_clouds)

        images = self._read_images(img_files)

        n_cam = cams["poses"].shape[0]
        f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
        i32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32))
        cam_metadata = {
            "sensor_idxs": i32(cams["sensor_idxs"].reshape(-1, 1)),
            "velocities": f32(cam_vel["velocities"]),
        }
        if cfg.rolling_shutter_time > 0:
            cam_metadata["rolling_shutter_time"] = torch.full((n_cam, 1), float(cfg.rolling_shutter_time))
            cam_metadata["time_to_center_pixel"] = torch.full((n_cam, 1), float(cfg.time_to_center_pixel))

        cameras = Cameras(
            camera_to_worlds=f32(cams["poses"]),
            fx=f32(cams["fx"].reshape(-1, 1)),
            fy=f32(cams["fy"].reshape(-1, 1)),
            cx=f32(cams["cx"].reshape(-1, 1)),
            cy=f32(cams["cy"].reshape(-1, 1)),
            width=i32(cams["width"].reshape(-1, 1)),
            height=i32(cams["height"].reshape(-1, 1)),
            camera_type=torch.full((n_cam, 1), int(CameraType.PERSPECTIVE), dtype=torch.int32),
            distortion_params=f32(cams["distortion"]) if "distortion" in cams else None,
            times=f32(cams["times"].reshape(-1, 1)),
            metadata=cam_metadata,
        )
        lidars = Lidars(
            lidar_to_worlds=f32(lids["poses"]),
            lidar_type=i32(lids.get("lidar_type", np.full(len(pc_files), int(LidarType.PANDAR64))).reshape(-1, 1)),
            times=f32(lids["times"].reshape(-1, 1)),
            metadata={
                "sensor_idxs": i32(lid_sensor_idxs.reshape(-1, 1)),
                "velocities": f32(lid_vel["velocities"]),
            },
        )

        duration = float(
            max(cams["times"].max(), lids["times"].max()) - min(cams["times"].min(), lids["times"].min())
        )
        return ADDataparserOutputs(
            cameras=cameras,
            images=images,
            lidars=lidars,
            point_clouds=[pc.astype(np.float32) for pc in point_clouds],
            scene_box=SceneBox(aabb=f32(aabb)),
            trajectories=trajectories,
            duration=duration,
            sensor_idx_to_name=sensor_idx_to_name,
            eval_camera_indices=tuple(cam_eval.tolist()),
            eval_lidar_indices=tuple(lid_eval.tolist()),
            metadata={
                "lane_shift_sign": self._get_lane_shift_sign(cfg.sequence),
                "dataparser_transform": w2m,
                "time_offset": float(min_time),
                "train_camera_indices": tuple(cam_train.tolist()),
                "train_lidar_indices": tuple(lid_train.tolist()),
            },
        )

    # ---- missing point synthesis (`ad_dataparser.py:471-610`) ----

    lidar_name_for_missing_points: Optional[str] = None  # e.g. "PANDAR64"

    def _add_missing_points(self, lids: dict, point_clouds: List[np.ndarray]) -> List[np.ndarray]:
        """Insert DUMMY_DISTANCE points at azimuth gaps per channel
        (`ad_dataparser.py:471-610`): for each lidar channel (nearest-elevation
        assignment), azimuth steps with no return get a synthetic point at
        DUMMY_DISTANCE so ray-drop learns where the lidar saw nothing."""
        if self.lidar_name_for_missing_points is None:
            return point_clouds
        from neurad_tpu_torch.data.lidar_elevation_mappings import AZIMUTH_RESOLUTION, ELEVATION_MAPPINGS
        from neurad_tpu_torch.data.native_ops import bin_points

        elevs = ELEVATION_MAPPINGS[self.lidar_name_for_missing_points]
        azim_res = AZIMUTH_RESOLUTION[self.lidar_name_for_missing_points]
        n_azim = int(round(360.0 / azim_res))

        out = []
        for pc in point_clouds:
            occupied, _, _ = bin_points(pc[:, :3].astype(np.float32), elevs, azim_res, n_azim)
            miss_ch, miss_az = np.nonzero(~occupied)
            if len(miss_ch) == 0:
                out.append(pc)
                continue
            theta = np.deg2rad(miss_az * azim_res - 180.0 + azim_res / 2.0)
            phi = np.deg2rad(elevs[miss_ch])
            dirs = np.stack(
                [np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta), np.sin(phi)], axis=-1
            )
            missing = np.zeros((len(miss_ch), pc.shape[1]), dtype=pc.dtype)
            missing[:, :3] = dirs * DUMMY_DISTANCE_VALUE
            out.append(np.concatenate([pc, missing]))
        return out
