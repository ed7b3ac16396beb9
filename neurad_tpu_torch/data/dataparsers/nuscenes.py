"""nuScenes dataparser (raw v1.0 JSON tables, no devkit dependency).

Torch port of `neurad_tpu/data/dataparsers/nuscenes.py`. Reads the dataset's
relational JSON tables directly (imageio for the JPEGs):

  <root>/v1.0-{version}/{scene,sample,sample_data,ego_pose,calibrated_sensor,
                         sensor,instance,sample_annotation,category}.json
  <root>/samples/<CHANNEL>/*.jpg | LIDAR_TOP/*.pcd.bin (float32 x,y,z,i,ring)

Conventions preserved from the reference: sensor pose = ego_pose ∘
calibrated_sensor; actor boxes rotated WLH->LWH (nuScenes actors are x-forward,
ours x-right/y-forward, `nuscenes_dataparser.py:63-76`); per-point time offsets
spread over the 20 Hz sweep.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from neurad_tpu_torch.data.dataparsers.ad_dataparser import (
    ADDataParser,
    ADDataParserConfig,
    OPENCV_TO_OPENGL,
    _quat_to_rotmat,
)

LIDAR_FREQUENCY = 20.0  # Hz (`nuscenes_dataparser.py:41`)
LIDAR_CHANNELS = 32

ALLOWED_RIGID_CLASSES = (
    "vehicle.car", "vehicle.bicycle", "vehicle.motorcycle", "vehicle.bus",
    "vehicle.truck", "vehicle.trailer", "movable_object.pushable_pullable",
)
ALLOWED_DEFORMABLE_CLASSES = ("human.pedestrian",)

AVAILABLE_CAMERAS = (
    "CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)

# nuScenes actor frame is x-forward/y-left; ours x-right/y-forward
# (`nuscenes_dataparser.py:63-76`)
WLH_TO_LWH = np.array(
    [[0.0, 1.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
)


def _pose_to_matrix(record: dict) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _quat_to_rotmat(*record["rotation"])
    m[:3, 3] = record["translation"]
    return m


@dataclasses.dataclass
class NuScenesDataParserConfig(ADDataParserConfig):
    """nuScenes options (`nuscenes_dataparser.py:121-178`)."""
    # missing-point synthesis ON by default (the sensor table is known here;
    # reference parsers default add_missing_points=True, e.g. zod_dataparser.py:175)
    add_missing_points: bool = True

    data: str = "data/nuscenes"
    version: str = "v1.0-mini"
    sequence: str = "scene-0061"
    cameras: Tuple[str, ...] = ("CAM_FRONT",)
    lidars: Tuple[str, ...] = ("LIDAR_TOP",)
    include_deformable_actors: bool = True

    def setup(self) -> "NuScenesDataParser":
        return NuScenesDataParser(self)


class NuScenesDataParser(ADDataParser):
    """Raw-table nuScenes reader."""

    config: NuScenesDataParserConfig
    lidar_name_for_missing_points = "VELODYNE_HDL32E"

    def __init__(self, config: NuScenesDataParserConfig):
        super().__init__(config)
        self.root = Path(config.data)
        table_dir = self.root / config.version
        if not table_dir.exists():
            raise FileNotFoundError(f"nuScenes tables not found: {table_dir}")
        self._tables: Dict[str, Dict[str, dict]] = {}
        for name in ("scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
                     "sensor", "instance", "sample_annotation", "category"):
            rows = json.loads((table_dir / f"{name}.json").read_text())
            self._tables[name] = {r["token"]: r for r in rows}
        self._scene = next(
            (s for s in self._tables["scene"].values() if s["name"] == config.sequence), None
        )
        if self._scene is None:
            raise ValueError(f"sequence {config.sequence!r} not in {config.version}")
        # ordered keyframe samples of the scene
        self.samples: List[dict] = []
        tok = self._scene["first_sample_token"]
        while tok:
            s = self._tables["sample"][tok]
            self.samples.append(s)
            tok = s["next"]
        # index sample_data by (sample_token, channel) for keyframes
        self._sd_by_sample: Dict[Tuple[str, str], dict] = {}
        for sd in self._tables["sample_data"].values():
            if not sd["is_key_frame"]:
                continue
            sensor = self._tables["sensor"][self._tables["calibrated_sensor"][sd["calibrated_sensor_token"]]["sensor_token"]]
            self._sd_by_sample[(sd["sample_token"], sensor["channel"])] = sd

    def _sensor_to_world(self, sd: dict) -> np.ndarray:
        ego = _pose_to_matrix(self._tables["ego_pose"][sd["ego_pose_token"]])
        calib = _pose_to_matrix(self._tables["calibrated_sensor"][sd["calibrated_sensor_token"]])
        return ego @ calib

    def _get_cameras(self) -> Tuple[dict, List]:
        cfg = self.config
        cams = list(AVAILABLE_CAMERAS) if "all" in cfg.cameras else list(cfg.cameras)
        poses, fx, fy, cx, cy, widths, heights, times, idxs, files = ([] for _ in range(10))
        for sample in self.samples:
            for ci, ch in enumerate(cams):
                sd = self._sd_by_sample.get((sample["token"], ch))
                if sd is None:
                    continue
                pose = self._sensor_to_world(sd)
                pose[:3, :3] = pose[:3, :3] @ OPENCV_TO_OPENGL
                calib = self._tables["calibrated_sensor"][sd["calibrated_sensor_token"]]
                K = np.asarray(calib["camera_intrinsic"])
                poses.append(pose[:3, :4])
                fx.append(K[0, 0]); fy.append(K[1, 1]); cx.append(K[0, 2]); cy.append(K[1, 2])
                widths.append(sd["width"]); heights.append(sd["height"])
                times.append(sd["timestamp"] / 1e6)
                idxs.append(ci)
                files.append(self.root / sd["filename"])
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
        for sample in self.samples:
            sd = self._sd_by_sample.get((sample["token"], "LIDAR_TOP"))
            if sd is None:
                continue
            poses.append(self._sensor_to_world(sd)[:3, :4])
            times.append(sd["timestamp"] / 1e6)
            idxs.append(0)
            files.append(self.root / sd["filename"])
        return {
            "poses": np.asarray(poses, dtype=np.float32),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.asarray(idxs, dtype=np.int64),
        }, files

    def _read_lidars(self, lids: dict, filepaths: List) -> List[np.ndarray]:
        """LIDAR_TOP .pcd.bin: float32 (x, y, z, intensity, ring) x N; per-point
        time offsets spread over the sweep (`nuscenes_dataparser.py:285-295`)."""
        out = []
        for fp in filepaths:
            raw = np.fromfile(fp, dtype=np.float32).reshape(-1, 5)
            n = raw.shape[0]
            offsets = np.repeat(
                np.linspace(-1.0 / LIDAR_FREQUENCY, 0.0, max(n // LIDAR_CHANNELS, 1)),
                LIDAR_CHANNELS,
            )[:n]
            if offsets.shape[0] < n:
                offsets = np.pad(offsets, (0, n - offsets.shape[0]))
            pc = np.concatenate(
                [raw[:, :3], raw[:, 3:4] / 255.0, offsets[:, None].astype(np.float32)], axis=-1
            )
            out.append(pc)
        return out

    def _read_images(self, filenames: List) -> List[np.ndarray]:
        import imageio.v2 as imageio

        return [np.asarray(imageio.imread(f)) for f in filenames]

    def _get_actor_trajectories(self) -> List[dict]:
        cfg = self.config
        allowed = ALLOWED_RIGID_CLASSES + (
            ALLOWED_DEFORMABLE_CLASSES if cfg.include_deformable_actors else ()
        )
        sample_tokens = {s["token"]: i for i, s in enumerate(self.samples)}
        by_instance: Dict[str, List[dict]] = {}
        for ann in self._tables["sample_annotation"].values():
            if ann["sample_token"] not in sample_tokens:
                continue
            inst = self._tables["instance"][ann["instance_token"]]
            cat = self._tables["category"][inst["category_token"]]["name"]
            if not any(cat.startswith(a) for a in allowed):
                continue
            by_instance.setdefault(ann["instance_token"], []).append((ann, cat))

        # lidar keyframe times index the trajectory timestamps
        times = {}
        for s in self.samples:
            sd = self._sd_by_sample.get((s["token"], "LIDAR_TOP"))
            if sd is not None:
                times[s["token"]] = sd["timestamp"] / 1e6

        trajs = []
        for inst_tok, entries in by_instance.items():
            entries.sort(key=lambda e: times.get(e[0]["sample_token"], 0.0))
            poses, ts, dims = [], [], []
            cat = entries[0][1]
            for ann, _ in entries:
                if ann["sample_token"] not in times:
                    continue
                pose = np.eye(4)
                pose[:3, :3] = _quat_to_rotmat(*ann["rotation"])
                pose[:3, 3] = ann["translation"]
                pose = pose @ WLH_TO_LWH  # actor x-forward -> x-right
                poses.append(pose.astype(np.float32))
                ts.append(times[ann["sample_token"]])
                w, l, h = ann["size"]
                dims.append([w, l, h])
            if len(poses) < 2:
                continue
            # static actors are not modeled as actors (reference filters stationary)
            positions = np.asarray([p[:3, 3] for p in poses])
            if np.linalg.norm(positions.max(0) - positions.min(0)) < 0.5:
                continue
            trajs.append(
                {
                    "poses": np.stack(poses),
                    "timestamps": np.asarray(ts),
                    "dims": np.asarray(dims, dtype=np.float32).max(0),
                    "label": cat,
                    "symmetric": "pedestrian" not in cat,
                    "deformable": "pedestrian" in cat,
                }
            )
        return trajs
