"""KITTI-MOT dataparser (raw tracking-benchmark layout).

Torch port of `neurad_tpu/data/dataparsers/kitti.py`; the camera frames are
read with the port's own PNG reader (`data/png.py`), so the parser needs
nothing beyond numpy. Reads the raw layout:

  <root>/training/image_02/<seq>/NNNNNN.png      left color camera
  <root>/training/velodyne/<seq>/NNNNNN.bin      float32 (x, y, z, reflectance)
  <root>/training/label_02/<seq>.txt             tracked 3D boxes (camera frame)
  <root>/training/oxts/<seq>.txt                 GPS/IMU per frame
  <root>/training/calib/<seq>.txt                P2, R_rect, Tr_velo_cam, Tr_imu_velo

Ego poses come from OXTS via the standard mercator projection; boxes are
transformed camera->world. 10 Hz capture.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from neurad_tpu_torch.data.dataparsers.ad_dataparser import (
    ADDataParser,
    ADDataParserConfig,
    OPENCV_TO_OPENGL,
)
from neurad_tpu_torch.data.png import read_png, read_png_size

FRAME_RATE = 10.0
EARTH_RADIUS = 6378137.0
ALLOWED_RIGID_CLASSES = ("Car", "Van", "Truck", "Tram")
ALLOWED_DEFORMABLE_CLASSES = ("Pedestrian", "Cyclist", "Person_sitting")


def _oxts_to_pose(oxts: np.ndarray, scale: float) -> np.ndarray:
    """One OXTS row -> IMU-to-world [4,4] (standard KITTI mercator projection)."""
    lat, lon, alt, roll, pitch, yaw = oxts[:6]
    tx = scale * np.deg2rad(lon) * EARTH_RADIUS
    ty = scale * EARTH_RADIUS * np.log(np.tan(np.pi / 4.0 + np.deg2rad(lat) / 2.0))
    rx = np.array([[1, 0, 0], [0, np.cos(roll), -np.sin(roll)], [0, np.sin(roll), np.cos(roll)]])
    ry = np.array([[np.cos(pitch), 0, np.sin(pitch)], [0, 1, 0], [-np.sin(pitch), 0, np.cos(pitch)]])
    rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = rz @ ry @ rx
    m[:3, 3] = [tx, ty, alt]
    return m


def _read_calib(path: Path) -> Dict[str, np.ndarray]:
    out = {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        key, _, vals = line.partition(":")
        if not vals:
            key, _, vals = line.partition(" ")
        arr = np.array([float(v) for v in vals.split()])
        out[key.strip()] = arr
    return out


@dataclasses.dataclass
class KittiMotDataParserConfig(ADDataParserConfig):
    data: str = "data/kitti-mot"
    sequence: str = "0006"
    cameras: Tuple[str, ...] = ("image_02",)
    lidars: Tuple[str, ...] = ("velodyne",)
    include_deformable_actors: bool = True
    # missing-point synthesis ON by default (the sensor table is known here;
    # reference parsers default add_missing_points=True, e.g. zod_dataparser.py:175)
    add_missing_points: bool = True

    def setup(self) -> "KittiMotDataParser":
        return KittiMotDataParser(self)


class KittiMotDataParser(ADDataParser):
    config: KittiMotDataParserConfig
    lidar_name_for_missing_points = "VELODYNE64E"

    def __init__(self, config: KittiMotDataParserConfig):
        super().__init__(config)
        self.train_dir = Path(config.data) / "training"
        seq = config.sequence
        if not (self.train_dir / "image_02" / seq).exists():
            raise FileNotFoundError(f"KITTI-MOT sequence not found: {self.train_dir / 'image_02' / seq}")
        calib = _read_calib(self.train_dir / "calib" / f"{seq}.txt")
        self.P2 = calib["P2"].reshape(3, 4)
        r_rect = np.eye(4)
        r_rect[:3, :3] = calib.get("R_rect", calib.get("R0_rect")).reshape(3, 3)
        self.r_rect = r_rect
        tr = np.eye(4)
        tr[:3, :4] = calib.get("Tr_velo_cam", calib.get("Tr_velo_to_cam")).reshape(3, 4)
        self.velo_to_cam = tr
        tri = np.eye(4)
        tri[:3, :4] = calib.get("Tr_imu_velo", calib.get("Tr_imu_to_velo")).reshape(3, 4)
        self.imu_to_velo = tri

        oxts = np.loadtxt(self.train_dir / "oxts" / f"{seq}.txt").reshape(-1, 30)
        scale = np.cos(np.deg2rad(oxts[0, 0]))
        imu_poses = np.stack([_oxts_to_pose(row, scale) for row in oxts])
        imu_poses = np.linalg.inv(imu_poses[0])[None] @ imu_poses  # first frame = origin
        self.imu_poses = imu_poses  # [T, 4, 4] imu->world
        self.n_frames = imu_poses.shape[0]
        self.times = np.arange(self.n_frames) / FRAME_RATE
        # rectified-camera-to-world per frame: imu->world @ (rect cam <- imu)
        cam_from_imu = self.r_rect @ self.velo_to_cam @ self.imu_to_velo
        self.cam_poses = imu_poses @ np.linalg.inv(cam_from_imu)[None]
        self.velo_poses = imu_poses @ np.linalg.inv(self.imu_to_velo)[None]

    def _get_cameras(self) -> Tuple[dict, List]:
        seq = self.config.sequence
        files = sorted((self.train_dir / "image_02" / seq).glob("*.png"))[: self.n_frames]
        h, w = read_png_size(files[0])
        n = len(files)
        poses = self.cam_poses[:n, :3, :4].astype(np.float32).copy()
        poses[:, :3, :3] = poses[:, :3, :3] @ OPENCV_TO_OPENGL
        return {
            "poses": poses,
            "fx": np.full(n, self.P2[0, 0], dtype=np.float32),
            "fy": np.full(n, self.P2[1, 1], dtype=np.float32),
            "cx": np.full(n, self.P2[0, 2], dtype=np.float32),
            "cy": np.full(n, self.P2[1, 2], dtype=np.float32),
            "width": np.full(n, w, dtype=np.int64),
            "height": np.full(n, h, dtype=np.int64),
            "times": self.times[:n].astype(np.float64),
            "sensor_idxs": np.zeros(n, dtype=np.int64),
        }, files

    def _get_lidars(self) -> Tuple[dict, List]:
        seq = self.config.sequence
        files = sorted((self.train_dir / "velodyne" / seq).glob("*.bin"))[: self.n_frames]
        n = len(files)
        return {
            "poses": self.velo_poses[:n, :3, :4].astype(np.float32),
            "times": self.times[:n].astype(np.float64),
            "sensor_idxs": np.zeros(n, dtype=np.int64),
        }, files

    def _read_lidars(self, lids: dict, filepaths: List) -> List[np.ndarray]:
        out = []
        for fp in filepaths:
            raw = np.fromfile(fp, dtype=np.float32).reshape(-1, 4)
            pc = np.concatenate([raw[:, :3], raw[:, 3:4], np.zeros((raw.shape[0], 1), np.float32)], axis=-1)
            out.append(pc)
        return out

    def _read_images(self, filenames: List) -> List[np.ndarray]:
        return [read_png(f) for f in filenames]

    def _get_actor_trajectories(self) -> List[dict]:
        cfg = self.config
        allowed = ALLOWED_RIGID_CLASSES + (
            ALLOWED_DEFORMABLE_CLASSES if cfg.include_deformable_actors else ()
        )
        label_file = self.train_dir / "label_02" / f"{cfg.sequence}.txt"
        if not label_file.exists():
            return []
        by_track: Dict[int, List[dict]] = {}
        for line in label_file.read_text().splitlines():
            parts = line.split()
            if len(parts) < 17:
                continue
            frame, track_id, cls = int(parts[0]), int(parts[1]), parts[2]
            if cls not in allowed or frame >= self.n_frames:
                continue
            h, w, l = float(parts[10]), float(parts[11]), float(parts[12])
            x, y, z = float(parts[13]), float(parts[14]), float(parts[15])  # rect cam frame
            ry = float(parts[16])
            # box pose in rect-camera frame: yaw about camera y; center at bottom face
            pose_cam = np.eye(4)
            pose_cam[:3, :3] = np.array(
                [[np.cos(ry), 0, np.sin(ry)], [0, 1, 0], [-np.sin(ry), 0, np.cos(ry)]]
            )
            pose_cam[:3, 3] = [x, y - h / 2.0, z]
            pose_world = self.cam_poses[frame] @ pose_cam
            # camera-frame box axes (x right, y down, z fwd) -> ours (x right, y fwd, z up)
            axes = np.eye(4)
            axes[:3, :3] = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]]).T
            pose_world = pose_world @ axes
            by_track.setdefault(track_id, []).append(
                {"frame": frame, "pose": pose_world.astype(np.float32), "dims": np.array([w, l, h], np.float32),
                 "cls": cls}
            )

        trajs = []
        for tid, entries in by_track.items():
            entries.sort(key=lambda e: e["frame"])
            if len(entries) < 2:
                continue
            positions = np.stack([e["pose"][:3, 3] for e in entries])
            if np.linalg.norm(positions.max(0) - positions.min(0)) < 0.5:
                continue  # stationary
            cls = entries[0]["cls"]
            trajs.append(
                {
                    "poses": np.stack([e["pose"] for e in entries]),
                    "timestamps": np.asarray([self.times[e["frame"]] for e in entries]),
                    "dims": np.stack([e["dims"] for e in entries]).max(0),
                    "label": cls,
                    "symmetric": cls not in ALLOWED_DEFORMABLE_CLASSES,
                    "deformable": cls in ALLOWED_DEFORMABLE_CLASSES,
                }
            )
        return trajs
