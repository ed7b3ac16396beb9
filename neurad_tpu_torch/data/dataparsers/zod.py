"""ZOD (Zenseact Open Dataset) sequences dataparser.

Torch port of `neurad_tpu/data/dataparsers/zod.py`. Like the upstream parser, this parser reads through the `zod` devkit (the raw
sequence layout packs OXTS in HDF5 and calibration in devkit-versioned JSON);
install `zod` to use it — the import is gated so the rest of the framework works
without it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from neurad_tpu_torch.data.dataparsers.ad_dataparser import (
    ADDataParser,
    ADDataParserConfig,
    OPENCV_TO_OPENGL,
)

ALLOWED_RIGID_CATEGORIES = ("Vehicle", "LargeVehicle", "Motorcyclist", "Bicyclist", "Trailer")
DEFORMABLE_CATEGORIES = ("Pedestrian",)
MAX_INTENSITY_VALUE = 255.0
HOOD_HEIGHT_PX = 750  # bottom crop removes the ego hood (`zod_dataparser.py:66`)


@dataclasses.dataclass
class ZodDataParserConfig(ADDataParserConfig):
    data: str = "data/zod"
    sequence: str = "000000"
    version: str = "full"
    cameras: Tuple[str, ...] = ("front",)
    lidars: Tuple[str, ...] = ("top",)
    include_deformable_actors: bool = True
    # missing-point synthesis ON by default (the sensor table is known here;
    # reference parsers default add_missing_points=True, e.g. zod_dataparser.py:175)
    add_missing_points: bool = True

    def setup(self) -> "ZodDataParser":
        return ZodDataParser(self)


class ZodDataParser(ADDataParser):
    config: ZodDataParserConfig
    lidar_name_for_missing_points = "VELODYNE128"

    def __init__(self, config: ZodDataParserConfig):
        super().__init__(config)
        try:
            from zod import ZodSequences
        except ImportError as e:  # pragma: no cover - devkit not in CI image
            raise ImportError(
                "The ZOD dataparser needs the `zod` devkit (pip install zod) — the raw "
                "sequence layout stores OXTS/calibration in devkit-versioned containers."
            ) from e
        self._sequences = ZodSequences(config.data, config.version)
        self._seq = self._sequences[config.sequence]

    def _get_cameras(self) -> Tuple[dict, List]:
        from zod.constants import Anonymization

        frames = self._seq.info.get_camera_frames(anonymization=Anonymization.BLUR)
        calib = self._seq.calibration
        cam = list(calib.cameras.values())[0]
        poses, times, files = [], [], []
        for f in frames:
            ego_pose = self._seq.ego_motion.get_poses(f.time.timestamp())
            pose = ego_pose @ cam.extrinsics.transform
            pose[:3, :3] = pose[:3, :3] @ OPENCV_TO_OPENGL
            poses.append(pose[:3, :4].astype(np.float32))
            times.append(f.time.timestamp())
            files.append(f.filepath)
        n = len(frames)
        K = cam.intrinsics
        return {
            "poses": np.asarray(poses, dtype=np.float32),
            "fx": np.full(n, K[0, 0], dtype=np.float32),
            "fy": np.full(n, K[1, 1], dtype=np.float32),
            "cx": np.full(n, K[0, 2], dtype=np.float32),
            "cy": np.full(n, K[1, 2], dtype=np.float32),
            "width": np.full(n, cam.image_dimensions[0], dtype=np.int64),
            "height": np.full(n, min(cam.image_dimensions[1], HOOD_HEIGHT_PX), dtype=np.int64),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.zeros(n, dtype=np.int64),
        }, files

    def _get_lidars(self) -> Tuple[dict, List]:
        frames = self._seq.info.get_lidar_frames()
        calib = self._seq.calibration
        lid = list(calib.lidars.values())[0]
        poses, times, files = [], [], []
        for f in frames:
            ego_pose = self._seq.ego_motion.get_poses(f.time.timestamp())
            pose = ego_pose @ lid.extrinsics.transform
            poses.append(pose[:3, :4].astype(np.float32))
            times.append(f.time.timestamp())
            files.append(f.filepath)
        n = len(frames)
        return {
            "poses": np.asarray(poses, dtype=np.float32),
            "times": np.asarray(times, dtype=np.float64),
            "sensor_idxs": np.zeros(n, dtype=np.int64),
        }, files

    def _read_lidars(self, lids: dict, filepaths: List) -> List[np.ndarray]:
        out = []
        for i, fp in enumerate(filepaths):
            raw = np.load(fp)
            xyz = np.stack([raw["x"], raw["y"], raw["z"]], axis=-1).astype(np.float32)
            intensity = (raw["intensity"].astype(np.float32) / MAX_INTENSITY_VALUE)[:, None]
            tdiff = (raw["timestamp"].astype(np.float64) / 1e6 - lids["times"][i]).astype(np.float32)[:, None]
            out.append(np.concatenate([xyz, intensity, tdiff], axis=-1))
        return out

    def _read_images(self, filenames: List) -> List[np.ndarray]:
        import imageio.v2 as imageio

        return [np.asarray(imageio.imread(f))[:HOOD_HEIGHT_PX] for f in filenames]

    def _get_actor_trajectories(self) -> List[dict]:
        cfg = self.config
        allowed = ALLOWED_RIGID_CATEGORIES + (
            DEFORMABLE_CATEGORIES if cfg.include_deformable_actors else ()
        )
        by_uuid = {}
        for ann_frame in self._seq.info.get_annotation_frames():
            for obj in ann_frame.read():
                if obj.name not in allowed or obj.box3d is None:
                    continue
                box = obj.box3d
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = box.orientation.rotation_matrix
                pose[:3, 3] = box.center
                by_uuid.setdefault(obj.uuid, []).append(
                    {
                        "pose": pose,
                        "time": ann_frame.time.timestamp(),
                        "dims": np.asarray(box.size, dtype=np.float32),
                        "label": obj.name,
                    }
                )
        trajs = []
        for uuid, entries in by_uuid.items():
            entries.sort(key=lambda e: e["time"])
            if len(entries) < 2:
                continue
            positions = np.stack([e["pose"][:3, 3] for e in entries])
            if np.linalg.norm(positions.max(0) - positions.min(0)) < 0.5:
                continue
            label = entries[0]["label"]
            trajs.append(
                {
                    "poses": np.stack([e["pose"] for e in entries]),
                    "timestamps": np.asarray([e["time"] for e in entries]),
                    "dims": np.stack([e["dims"] for e in entries]).max(0),
                    "label": label,
                    "symmetric": label not in DEFORMABLE_CATEGORIES,
                    "deformable": label in DEFORMABLE_CATEGORIES,
                }
            )
        return trajs
