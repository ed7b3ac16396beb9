"""Waymo Open Dataset dataparser (v2 parquet layout, pyarrow-based).

Torch port of `neurad_tpu/data/dataparsers/waymo.py`. The upstream parser consumes the v1 TFRecord protos
through the `waymo-open-dataset` package; this parser reads the **v2 ("modular")
parquet layout** instead, which needs only pyarrow/pandas (both in-image):

  <root>/<split>/camera_image/<segment>.parquet
  <root>/<split>/camera_calibration/<segment>.parquet
  <root>/<split>/lidar/<segment>.parquet              (range images)
  <root>/<split>/lidar_calibration/<segment>.parquet
  <root>/<split>/vehicle_pose/<segment>.parquet
  <root>/<split>/lidar_box/<segment>.parquet

Waymo camera frames are x-forward/y-left/z-up (FLU); converted to OpenCV then
OpenGL. Rolling shutter is horizontal on Waymo side cameras
(`wod_dataparser.py` rs_direction="Horizontal").
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

ALLOWED_RIGID_TYPES = (1,)  # TYPE_VEHICLE
ALLOWED_DEFORMABLE_TYPES = (2, 4)  # TYPE_PEDESTRIAN, TYPE_CYCLIST

# FLU (x fwd, y left, z up) camera -> OpenCV (x right, y down, z fwd)
FLU_TO_OPENCV = np.array(
    [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], dtype=np.float64
)


@dataclasses.dataclass
class WaymoDataParserConfig(ADDataParserConfig):
    data: str = "data/waymo/v2"
    split: str = "training"
    sequence: str = ""  # segment context name
    cameras: Tuple[str, ...] = ("1",)  # FRONT camera id
    lidars: Tuple[str, ...] = ("1",)  # TOP lidar id
    include_deformable_actors: bool = True
    rolling_shutter_time: float = 0.045
    # missing-point synthesis ON by default (the sensor table is known here;
    # reference parsers default add_missing_points=True, e.g. zod_dataparser.py:175)
    add_missing_points: bool = True

    def setup(self) -> "WaymoDataParser":
        return WaymoDataParser(self)


class WaymoDataParser(ADDataParser):
    config: WaymoDataParserConfig
    lidar_name_for_missing_points = "WOD64"

    def __init__(self, config: WaymoDataParserConfig):
        super().__init__(config)
        import pandas as pd

        self.root = Path(config.data) / config.split
        seg = config.sequence
        self._tables: Dict[str, "pd.DataFrame"] = {}
        for name in ("camera_image", "camera_calibration", "vehicle_pose", "lidar_box"):
            fp = self.root / name / f"{seg}.parquet"
            if not fp.exists():
                raise FileNotFoundError(
                    f"Waymo v2 component not found: {fp}. Download the v2 parquet layout "
                    f"(gs://waymo_open_dataset_v_2_*/...) — the v1 TFRecords need the "
                    f"waymo-open-dataset package, which is not a dependency here."
                )
            self._tables[name] = pd.read_parquet(fp)

    def _vehicle_pose_at(self, t_us: int) -> np.ndarray:
        vp = self._tables["vehicle_pose"]
        i = int(np.abs(vp["key.frame_timestamp_micros"].to_numpy() - t_us).argmin())
        return np.asarray(vp.iloc[i]["[VehiclePoseComponent].world_from_vehicle.transform"]).reshape(4, 4)

    def _get_cameras(self) -> Tuple[dict, List]:
        cfg = self.config
        imgs = self._tables["camera_image"]
        calib = self._tables["camera_calibration"]
        poses, fx, fy, cx, cy, widths, heights, times, idxs, files = ([] for _ in range(10))
        cam_ids = [int(c) for c in cfg.cameras]
        for ci, cam_id in enumerate(cam_ids):
            crow = calib[calib["key.camera_name"] == cam_id].iloc[0]
            # v2 intrinsics are separate scalar columns
            f_u = float(crow["[CameraCalibrationComponent].intrinsic.f_u"])
            f_v = float(crow["[CameraCalibrationComponent].intrinsic.f_v"])
            c_u = float(crow["[CameraCalibrationComponent].intrinsic.c_u"])
            c_v = float(crow["[CameraCalibrationComponent].intrinsic.c_v"])
            w = int(crow["[CameraCalibrationComponent].width"])
            h = int(crow["[CameraCalibrationComponent].height"])
            extr = np.asarray(crow["[CameraCalibrationComponent].extrinsic.transform"]).reshape(4, 4)
            sel = imgs[imgs["key.camera_name"] == cam_id]
            for _, row in sel.iterrows():
                t_us = int(row["key.frame_timestamp_micros"])
                pose = self._vehicle_pose_at(t_us) @ extr  # FLU camera in world
                pose[:3, :3] = pose[:3, :3] @ FLU_TO_OPENCV.T @ OPENCV_TO_OPENGL
                poses.append(pose[:3, :4].astype(np.float32))
                fx.append(f_u); fy.append(f_v); cx.append(c_u); cy.append(c_v)
                widths.append(w); heights.append(h)
                times.append(t_us / 1e6)
                idxs.append(ci)
                files.append(row["[CameraImageComponent].image"])  # raw jpeg bytes
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
        # lidar poses = vehicle pose (points stored in vehicle frame after decoding)
        vp = self._tables["vehicle_pose"]
        poses, times, idxs, files = [], [], [], []
        for _, row in vp.iterrows():
            t_us = int(row["key.frame_timestamp_micros"])
            m = np.asarray(row["[VehiclePoseComponent].world_from_vehicle.transform"]).reshape(4, 4)
            poses.append(m[:3, :4].astype(np.float32))
            times.append(t_us / 1e6)
            idxs.append(0)
            files.append(t_us)
        return {
            "poses": np.asarray(poses, dtype=np.float32),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.asarray(idxs, dtype=np.int64),
        }, files

    def _read_lidars(self, lids: dict, filepaths: List) -> List[np.ndarray]:
        """Decode the TOP-lidar range images to vehicle-frame point clouds.

        Full range-image decoding (beam inclinations + pixel-pose compensation)
        requires the lidar/lidar_calibration components; implemented for the
        common uniform-inclination fast path.
        """
        import pandas as pd

        lidar_fp = self.root / "lidar" / f"{self.config.sequence}.parquet"
        calib_fp = self.root / "lidar_calibration" / f"{self.config.sequence}.parquet"
        lidar_df = pd.read_parquet(lidar_fp)
        calib_df = pd.read_parquet(calib_fp)
        crow = calib_df[calib_df["key.laser_name"] == 1].iloc[0]
        extr = np.asarray(crow["[LiDARCalibrationComponent].extrinsic.transform"]).reshape(4, 4)
        incl_min = float(crow["[LiDARCalibrationComponent].beam_inclination.min"])
        incl_max = float(crow["[LiDARCalibrationComponent].beam_inclination.max"])

        out = []
        top = lidar_df[lidar_df["key.laser_name"] == 1]
        by_time = {int(r["key.frame_timestamp_micros"]): r for _, r in top.iterrows()}
        for t_us in filepaths:
            row = by_time[int(t_us)]
            vals = np.asarray(row["[LiDARComponent].range_image_return1.values"], dtype=np.float32)
            shape = np.asarray(row["[LiDARComponent].range_image_return1.shape"])
            ri = vals.reshape(shape)  # [H, W, 4]: range, intensity, elongation, is_in_nlz
            h, w = ri.shape[0], ri.shape[1]
            incl = np.linspace(incl_max, incl_min, h)[:, None]
            azim = np.linspace(np.pi, -np.pi, w, endpoint=False)[None, :]
            # correct azimuth by extrinsic yaw (sensor frame alignment)
            yaw = np.arctan2(extr[1, 0], extr[0, 0])
            azim = azim - yaw
            rng = ri[..., 0]
            valid = rng > 0
            x = rng * np.cos(incl) * np.cos(azim)
            y = rng * np.cos(incl) * np.sin(azim)
            z = rng * np.sin(incl)
            pts_sensor = np.stack([x[valid], y[valid], z[valid]], axis=-1)
            pts_vehicle = pts_sensor @ extr[:3, :3].T + extr[:3, 3]
            intensity = np.tanh(ri[..., 1][valid])[:, None]
            tdiff = np.zeros_like(intensity)
            out.append(
                np.concatenate([pts_vehicle, intensity, tdiff], axis=-1).astype(np.float32)
            )
        return out

    def _read_images(self, filenames: List) -> List[np.ndarray]:
        import io

        import imageio.v2 as imageio

        return [np.asarray(imageio.imread(io.BytesIO(b))) for b in filenames]

    def _get_actor_trajectories(self) -> List[dict]:
        cfg = self.config
        boxes = self._tables["lidar_box"]
        allowed = ALLOWED_RIGID_TYPES + (
            ALLOWED_DEFORMABLE_TYPES if cfg.include_deformable_actors else ()
        )
        trajs = []
        for uuid, group in boxes.groupby("key.laser_object_id"):
            group = group.sort_values("key.frame_timestamp_micros")
            otype = int(group.iloc[0]["[LiDARBoxComponent].type"])
            if otype not in allowed or len(group) < 2:
                continue
            poses, ts, dims = [], [], []
            for _, row in group.iterrows():
                t_us = int(row["key.frame_timestamp_micros"])
                heading = float(row["[LiDARBoxComponent].box.heading"])
                center = [
                    float(row["[LiDARBoxComponent].box.center.x"]),
                    float(row["[LiDARBoxComponent].box.center.y"]),
                    float(row["[LiDARBoxComponent].box.center.z"]),
                ]
                pose_v = np.eye(4)
                c, s = np.cos(heading), np.sin(heading)
                # waymo boxes x-forward; ours x-right/y-forward: extra -90deg yaw
                pose_v[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.array(
                    [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
                )
                pose_v[:3, 3] = center
                pose = self._vehicle_pose_at(t_us) @ pose_v
                poses.append(pose.astype(np.float32))
                ts.append(t_us / 1e6)
                dims.append(
                    [
                        float(row["[LiDARBoxComponent].box.size.y"]),  # width
                        float(row["[LiDARBoxComponent].box.size.x"]),  # length
                        float(row["[LiDARBoxComponent].box.size.z"]),  # height
                    ]
                )
            positions = np.stack([p[:3, 3] for p in poses])
            if np.linalg.norm(positions.max(0) - positions.min(0)) < 0.5:
                continue
            trajs.append(
                {
                    "poses": np.stack(poses),
                    "timestamps": np.asarray(ts),
                    "dims": np.asarray(dims, dtype=np.float32).max(0),
                    "label": {1: "Vehicle", 2: "Pedestrian", 4: "Cyclist"}.get(otype, "Other"),
                    "symmetric": otype not in ALLOWED_DEFORMABLE_TYPES,
                    "deformable": otype in ALLOWED_DEFORMABLE_TYPES,
                }
            )
        return trajs
