"""Argoverse 2 sensor-dataset parser (raw feather files, no devkit).

Torch port of `neurad_tpu/data/dataparsers/argoverse2.py` (pandas for the
feather files, imageio for the JPEGs). Raw layout per log:

  <root>/<log_id>/calibration/{egovehicle_SE3_sensor.feather, intrinsics.feather}
  <root>/<log_id>/sensors/cameras/<cam>/<t_ns>.jpg
  <root>/<log_id>/sensors/lidar/<t_ns>.feather   (x, y, z, intensity, laser_number, offset_ns)
  <root>/<log_id>/city_SE3_egovehicle.feather    (timestamp_ns, q, t)
  <root>/<log_id>/annotations.feather            (timestamp_ns, track_uuid, category, dims, pose)
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
    _quat_to_rotmat,
)

ALLOWED_RIGID_CLASSES = (
    "REGULAR_VEHICLE", "LARGE_VEHICLE", "BUS", "BOX_TRUCK", "TRUCK", "VEHICULAR_TRAILER",
    "TRUCK_CAB", "SCHOOL_BUS", "ARTICULATED_BUS", "MOTORCYCLE", "BICYCLE", "WHEELED_DEVICE",
)
ALLOWED_DEFORMABLE_CLASSES = ("PEDESTRIAN", "WHEELED_RIDER", "BICYCLIST", "MOTORCYCLIST", "OFFICIAL_SIGNALER")

AVAILABLE_CAMERAS = (
    "ring_front_center", "ring_front_left", "ring_front_right",
    "ring_rear_left", "ring_rear_right", "ring_side_left", "ring_side_right",
)


def _row_to_pose(row) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _quat_to_rotmat(row["qw"], row["qx"], row["qy"], row["qz"])
    m[:3, 3] = [row["tx_m"], row["ty_m"], row["tz_m"]]
    return m


@dataclasses.dataclass
class Argoverse2DataParserConfig(ADDataParserConfig):
    data: str = "data/argoverse2"
    sequence: str = ""  # log id
    cameras: Tuple[str, ...] = ("ring_front_center",)
    lidars: Tuple[str, ...] = ("lidar",)
    include_deformable_actors: bool = True
    # missing-point synthesis ON by default (the sensor table is known here;
    # reference parsers default add_missing_points=True, e.g. zod_dataparser.py:175)
    add_missing_points: bool = True

    def setup(self) -> "Argoverse2DataParser":
        return Argoverse2DataParser(self)


class Argoverse2DataParser(ADDataParser):
    lidar_name_for_missing_points = "ARGOVERSE2_VLP32C"
    config: Argoverse2DataParserConfig

    def __init__(self, config: Argoverse2DataParserConfig):
        super().__init__(config)
        import pandas as pd

        self.log_dir = Path(config.data) / config.sequence
        if not self.log_dir.exists():
            raise FileNotFoundError(f"AV2 log not found: {self.log_dir}")
        self.ego_poses = pd.read_feather(self.log_dir / "city_SE3_egovehicle.feather")
        self.extrinsics = pd.read_feather(self.log_dir / "calibration" / "egovehicle_SE3_sensor.feather")
        self.intrinsics = pd.read_feather(self.log_dir / "calibration" / "intrinsics.feather")
        self._ego_times = self.ego_poses["timestamp_ns"].to_numpy()
        self._ego_mats = np.stack([_row_to_pose(r) for _, r in self.ego_poses.iterrows()])

    def _ego_at(self, t_ns: int) -> np.ndarray:
        i = int(np.abs(self._ego_times - t_ns).argmin())
        return self._ego_mats[i]

    def _sensor_extrinsic(self, name: str) -> np.ndarray:
        row = self.extrinsics[self.extrinsics["sensor_name"] == name].iloc[0]
        return _row_to_pose(row)

    def _get_cameras(self) -> Tuple[dict, List]:
        cfg = self.config
        cams = list(AVAILABLE_CAMERAS) if "all" in cfg.cameras else list(cfg.cameras)
        poses, fx, fy, cx, cy, widths, heights, times, idxs, files = ([] for _ in range(10))
        for ci, cam in enumerate(cams):
            intr = self.intrinsics[self.intrinsics["sensor_name"] == cam].iloc[0]
            ext = self._sensor_extrinsic(cam)
            for fp in sorted((self.log_dir / "sensors" / "cameras" / cam).glob("*.jpg")):
                t_ns = int(fp.stem)
                pose = self._ego_at(t_ns) @ ext
                pose[:3, :3] = pose[:3, :3] @ OPENCV_TO_OPENGL
                poses.append(pose[:3, :4].astype(np.float32))
                fx.append(intr["fx_px"]); fy.append(intr["fy_px"])
                cx.append(intr["cx_px"]); cy.append(intr["cy_px"])
                widths.append(int(intr["width_px"])); heights.append(int(intr["height_px"]))
                times.append(t_ns / 1e9)
                idxs.append(ci)
                files.append(fp)
        return {
            "poses": np.asarray(poses, dtype=np.float32),
            "fx": np.asarray(fx, dtype=np.float32),
            "fy": np.asarray(fy, dtype=np.float32),
            "cx": np.asarray(cx, dtype=np.float32),
            "cy": np.asarray(cy, dtype=np.float32),
            "width": np.asarray(widths, dtype=np.int64),
            "height": np.asarray(heights, dtype=np.int64),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.asarray(idxs, dtype=np.int64),
        }, files

    def _get_lidars(self) -> Tuple[dict, List]:
        poses, times, idxs, files = [], [], [], []
        for fp in sorted((self.log_dir / "sensors" / "lidar").glob("*.feather")):
            t_ns = int(fp.stem)
            # AV2 lidar points come in the ego frame; use ego pose as lidar pose
            poses.append(self._ego_at(t_ns)[:3, :4].astype(np.float32))
            times.append(t_ns / 1e9)
            idxs.append(0)
            files.append(fp)
        return {
            "poses": np.asarray(poses, dtype=np.float32),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.asarray(idxs, dtype=np.int64),
        }, files

    def _read_lidars(self, lids: dict, filepaths: List) -> List[np.ndarray]:
        import pandas as pd

        out = []
        for i, fp in enumerate(filepaths):
            df = pd.read_feather(fp)
            xyz = df[["x", "y", "z"]].to_numpy(dtype=np.float32)
            intensity = (df["intensity"].to_numpy(dtype=np.float32) / 255.0)[:, None]
            if "offset_ns" in df:
                tdiff = (df["offset_ns"].to_numpy(dtype=np.float64) / 1e9).astype(np.float32)[:, None]
            else:
                tdiff = np.zeros_like(intensity)
            out.append(np.concatenate([xyz, intensity, tdiff], axis=-1))
        return out

    def _read_images(self, filenames: List) -> List[np.ndarray]:
        import imageio.v2 as imageio

        return [np.asarray(imageio.imread(f)) for f in filenames]

    def _get_actor_trajectories(self) -> List[dict]:
        import pandas as pd

        cfg = self.config
        ann_path = self.log_dir / "annotations.feather"
        if not ann_path.exists():
            return []
        allowed = ALLOWED_RIGID_CLASSES + (
            ALLOWED_DEFORMABLE_CLASSES if cfg.include_deformable_actors else ()
        )
        df = pd.read_feather(ann_path)
        df = df[df["category"].isin(allowed)]
        trajs = []
        for uuid, group in df.groupby("track_uuid"):
            group = group.sort_values("timestamp_ns")
            if len(group) < 2:
                continue
            poses, ts, dims = [], [], []
            for _, row in group.iterrows():
                pose_ego = _row_to_pose(row)
                pose = self._ego_at(int(row["timestamp_ns"])) @ pose_ego
                # AV2 boxes are x-forward; ours x-right/y-forward
                swap = np.eye(4)
                swap[:3, :3] = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]).T
                poses.append((pose @ swap).astype(np.float32))
                ts.append(row["timestamp_ns"] / 1e9)
                dims.append([row["width_m"], row["length_m"], row["height_m"]])
            positions = np.stack([p[:3, 3] for p in poses])
            if np.linalg.norm(positions.max(0) - positions.min(0)) < 0.5:
                continue
            cat = group.iloc[0]["category"]
            trajs.append(
                {
                    "poses": np.stack(poses),
                    "timestamps": np.asarray(ts),
                    "dims": np.asarray(dims, dtype=np.float32).max(0),
                    "label": cat,
                    "symmetric": cat not in ALLOWED_DEFORMABLE_CLASSES,
                    "deformable": cat in ALLOWED_DEFORMABLE_CLASSES,
                }
            )
        return trajs
