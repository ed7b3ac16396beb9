"""PandaSet dataparser (raw dataset layout, no devkit dependency).

Torch port of `neurad_tpu/data/dataparsers/pandaset.py`. Reads the public raw
layout directly (pandas for the pickles, imageio for the JPEGs):

  <root>/<seq>/camera/<cam>/{NN.jpg, poses.json, intrinsics.json, timestamps.json}
  <root>/<seq>/lidar/{NN.pkl.gz, poses.json, timestamps.json}
  <root>/<seq>/annotations/cuboids/NN.pkl.gz

The reference replaces the (buggy) per-scan lidar poses with front-camera pose x
a fixed lidar->camera extrinsic from a calibration yaml; pass `extrinsics_yaml`
to reproduce that, otherwise the dataset's own lidar poses.json is used.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from neurad_tpu_torch.data.dataparsers.ad_dataparser import (
    DUMMY_DISTANCE_VALUE,
    OPENCV_TO_OPENGL,
    ADDataParser,
    ADDataParserConfig,
    _quat_to_rotmat,
)

PANDASET_SEQ_LEN = 80
MAX_REFLECTANCE_VALUE = 255.0
BACK_CAMERA_BOTTOM_CROP = 260
PANDAR64_INDEX = 0  # 360deg mechanical lidar; 1 = PandarGT front lidar

ALLOWED_RIGID_CLASSES = (
    "Car", "Pickup Truck", "Medium-sized Truck", "Semi-truck", "Towed Object",
    "Motorcycle", "Other Vehicle - Construction Vehicle", "Other Vehicle - Uncommon",
    "Other Vehicle - Pedicab", "Emergency Vehicle", "Bus", "Personal Mobility Device",
    "Motorized Scooter", "Bicycle", "Train", "Trolley", "Tram / Subway",
)
ALLOWED_DEFORMABLE_CLASSES = ("Pedestrian", "Pedestrian with Object")

# Most-realistic lane-shift direction per sequence (`pandaset_dataparser.py:77-91`)
LANE_SHIFT_SIGN: Dict[str, int] = {
    "001": -1, "011": 1, "016": 1, "028": -1, "053": 1,
    "063": -1, "084": -1, "106": -1, "123": -1, "158": -1,
}

AVAILABLE_CAMERAS = ("front", "front_left", "front_right", "back", "left", "right")


def _pose_dict_to_matrix(pose: dict) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _quat_to_rotmat(
        pose["heading"]["w"], pose["heading"]["x"], pose["heading"]["y"], pose["heading"]["z"]
    )
    m[:3, 3] = [pose["position"]["x"], pose["position"]["y"], pose["position"]["z"]]
    return m


def _yaw_to_rotmat(yaw: np.ndarray) -> np.ndarray:
    r = np.zeros(yaw.shape + (3, 3))
    c, s = np.cos(yaw), np.sin(yaw)
    r[..., 0, 0], r[..., 0, 1] = c, -s
    r[..., 1, 0], r[..., 1, 1] = s, c
    r[..., 2, 2] = 1.0
    return r


@dataclasses.dataclass
class PandaSetDataParserConfig(ADDataParserConfig):
    """PandaSet options (`pandaset_dataparser.py:107-155`)."""
    # missing-point synthesis ON by default (the sensor table is known here;
    # reference parsers default add_missing_points=True, e.g. zod_dataparser.py:175)
    add_missing_points: bool = True

    data: str = "data/pandaset"
    sequence: str = "001"
    cameras: Tuple[str, ...] = ("front",)
    lidars: Tuple[str, ...] = ("Pandar64",)
    include_deformable_actors: bool = True
    rolling_shutter_time: float = 0.03  # `pandaset_dataparser.py:144-147`
    time_to_center_pixel: float = -0.01
    extrinsics_yaml: Optional[str] = None

    def setup(self) -> "PandaSetDataParser":
        return PandaSetDataParser(self)


class PandaSetDataParser(ADDataParser):
    """Raw-layout PandaSet reader."""

    config: PandaSetDataParserConfig
    lidar_name_for_missing_points = "PANDAR64"

    def __init__(self, config: PandaSetDataParserConfig):
        super().__init__(config)
        self.seq_dir = Path(config.data) / config.sequence
        if not self.seq_dir.exists():
            raise FileNotFoundError(f"PandaSet sequence dir not found: {self.seq_dir}")
        self._lidar_poses = None

    def _get_lane_shift_sign(self, sequence: str) -> int:
        return LANE_SHIFT_SIGN.get(sequence, -1)

    # ------------------------------------------------------------------

    def _camera_dir(self, cam: str) -> Path:
        return self.seq_dir / "camera" / f"{cam}_camera"

    def _get_cameras(self) -> Tuple[dict, List]:
        cfg = self.config
        cam_names = list(AVAILABLE_CAMERAS) if "all" in cfg.cameras else list(cfg.cameras)
        poses, fx, fy, cx, cy, times, idxs, heights, widths, files = ([] for _ in range(10))
        for i in range(PANDASET_SEQ_LEN):
            for ci, cam in enumerate(cam_names):
                d = self._camera_dir(cam)
                cam_poses = json.loads((d / "poses.json").read_text())
                intr = json.loads((d / "intrinsics.json").read_text())
                ts = json.loads((d / "timestamps.json").read_text())
                pose = _pose_dict_to_matrix(cam_poses[i])
                pose[:3, :3] = pose[:3, :3] @ OPENCV_TO_OPENGL
                poses.append(pose[:3, :4])
                fx.append(intr["fx"]); fy.append(intr["fy"]); cx.append(intr["cx"]); cy.append(intr["cy"])
                times.append(ts[i])
                idxs.append(ci)
                # back camera has a trunk-lid crop (`pandaset_dataparser.py:52,190`)
                heights.append(1080 - (BACK_CAMERA_BOTTOM_CROP if cam == "back" else 0))
                widths.append(1920)
                files.append(d / f"{i:02d}.jpg")
        cams = {
            "poses": np.asarray(poses, dtype=np.float32),
            "fx": np.asarray(fx, dtype=np.float32),
            "fy": np.asarray(fy, dtype=np.float32),
            "cx": np.asarray(cx, dtype=np.float32),
            "cy": np.asarray(cy, dtype=np.float32),
            "width": np.asarray(widths, dtype=np.int64),
            "height": np.asarray(heights, dtype=np.int64),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.asarray(idxs, dtype=np.int64),
        }
        return cams, files

    def _lidar_to_world(self, i: int) -> np.ndarray:
        """Per-scan lidar pose. With extrinsics_yaml: front_cam pose ∘ lidar->cam
        extrinsic (`pandaset_dataparser.py:218-226`); else lidar/poses.json."""
        if self.config.extrinsics_yaml:
            import yaml

            front_dir = self._camera_dir("front")
            cam_poses = json.loads((front_dir / "poses.json").read_text())
            front_c2w = _pose_dict_to_matrix(cam_poses[i])
            extr = yaml.safe_load(Path(self.config.extrinsics_yaml).read_text())["front_camera"]
            tr = extr["extrinsic"]["transform"]
            l2cam = _pose_dict_to_matrix({"position": tr["translation"], "heading": tr["rotation"]})
            return front_c2w @ l2cam
        if self._lidar_poses is None:
            self._lidar_poses = json.loads((self.seq_dir / "lidar" / "poses.json").read_text())
        return _pose_dict_to_matrix(self._lidar_poses[i])

    def _get_lidars(self) -> Tuple[dict, List]:
        # lidar scans are synced to front-camera timestamps (`pandaset_dataparser.py:219-232`)
        front_ts = json.loads((self._camera_dir("front") / "timestamps.json").read_text())
        poses, times, idxs, files = [], [], [], []
        for i in range(PANDASET_SEQ_LEN):
            poses.append(self._lidar_to_world(i)[:3, :4])
            times.append(front_ts[i])
            idxs.append(PANDAR64_INDEX)
            files.append(self.seq_dir / "lidar" / f"{i:02d}.pkl.gz")
        return {
            "poses": np.asarray(poses, dtype=np.float32),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.asarray(idxs, dtype=np.int64),
        }, files

    def _read_lidars(self, lids: dict, filepaths: List) -> List[np.ndarray]:
        """Raw scans are world-frame (x y z i t d); transform to sensor frame and
        make times relative to the scan time (`pandaset_dataparser.py:254-290`)."""
        import pandas as pd

        out = []
        for i, fp in enumerate(filepaths):
            pc = pd.read_pickle(fp).values.astype(np.float64)
            pc[:, 3] /= MAX_REFLECTANCE_VALUE
            l2w = np.eye(4)
            l2w[:3, :4] = lids["poses"][i]
            w2l = np.linalg.inv(l2w)
            xyz1 = np.concatenate([pc[:, :3], np.ones((pc.shape[0], 1))], axis=-1)
            pc[:, :3] = (xyz1 @ w2l.T)[:, :3]
            pc[:, 4] -= lids["times"][i]
            pc = pc[pc[:, -1] == PANDAR64_INDEX, :-1]  # keep the 360deg lidar
            out.append(pc.astype(np.float32))
        return out

    def _read_images(self, filenames: List) -> List[np.ndarray]:
        import imageio.v2 as imageio

        images = []
        for f in filenames:
            img = np.asarray(imageio.imread(f))
            if img.shape[0] == 1080 and "back_camera" in str(f):
                img = img[: 1080 - BACK_CAMERA_BOTTOM_CROP]
            images.append(img)  # uint8; datamanager normalizes patches
        return images

    # ------------------------------------------------------------------

    def _get_actor_trajectories(self) -> List[dict]:
        """Cuboid annotations -> per-uuid trajectories
        (`pandaset_dataparser.py:322-390,539-567`)."""
        import pandas as pd

        cfg = self.config
        allowed = ALLOWED_RIGID_CLASSES + (
            ALLOWED_DEFORMABLE_CLASSES if cfg.include_deformable_actors else ()
        )
        front_ts = json.loads((self._camera_dir("front") / "timestamps.json").read_text())
        trajs_dict: Dict[str, List[dict]] = {}
        for i in range(PANDASET_SEQ_LEN):
            fp = self.seq_dir / "annotations" / "cuboids" / f"{i:02d}.pkl.gz"
            if not fp.exists():
                continue
            df = pd.read_pickle(fp)
            is_allowed = df["label"].isin(allowed)
            valid = (~df["stationary"]) & is_allowed
            df = df[valid]
            if not len(df):
                continue
            sensor_id = df.get("cuboids.sensor_id")
            for row_idx in range(len(df)):
                row = df.iloc[row_idx]
                if sensor_id is not None and int(row["cuboids.sensor_id"]) == 1:
                    continue  # skip front-lidar duplicate cuboids
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = _yaw_to_rotmat(np.asarray(row["yaw"], dtype=np.float32))
                pose[:3, 3] = [row["position.x"], row["position.y"], row["position.z"]]
                trajs_dict.setdefault(row["uuid"], []).append(
                    {
                        "pose": pose,
                        "time": float(front_ts[i]),
                        "dims": np.array(
                            [row["dimensions.x"], row["dimensions.y"], row["dimensions.z"]],
                            dtype=np.float32,
                        ),
                        "label": row["label"],
                    }
                )

        trajs = []
        for uuid, entries in trajs_dict.items():
            entries.sort(key=lambda e: e["time"])
            label = entries[0]["label"]
            trajs.append(
                {
                    "poses": np.stack([e["pose"] for e in entries]),
                    "timestamps": np.asarray([e["time"] for e in entries]),
                    "dims": np.stack([e["dims"] for e in entries]).max(axis=0),
                    "label": label,
                    "symmetric": "Pedestrian" not in label,
                    "deformable": "Pedestrian" in label,
                }
            )
        return trajs
