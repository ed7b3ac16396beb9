"""Full-sensor datamanager for gaussian-splatting models (torch port of
`neurad_tpu/data/full_image_datamanager.py`).

Samples stay host-side numpy, as in the JAX package; the model moves them to
its device. Each lidar scan becomes a padded, fixed-size set of spherical query
points (azim, elev, depth, time, intensity). The train sampler is numpy's
generator, as in the JAX package: the same seed gives the same sequence of
samples on both sides, and its state rides the checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from portbench.reference.port.data.dataparsers.base import ADDataparserOutputs


@dataclasses.dataclass
class FullImageLidarDataManagerConfig:
    camera_fraction: float = 0.5  # probability of a camera step vs lidar step
    max_lidar_points: int = 131072  # raster_pts padding size (static shape)
    downscale_factor: int = 1


@dataclasses.dataclass
class CameraSample:
    c2w: np.ndarray  # [3, 4] OpenGL
    K: np.ndarray  # [3, 3]
    width: int
    height: int
    image: np.ndarray  # [H, W, 3] float
    time: float
    sensor_idx: int
    cam_idx: int
    linear_velocity: np.ndarray  # [3]
    rolling_shutter_time: float
    time_to_center_pixel: float


@dataclasses.dataclass
class LidarSample:
    l2w: np.ndarray  # [3, 4]
    raster_pts: np.ndarray  # [M, 5] (azim_deg, elev_deg, depth, timediff, intensity)
    did_return: np.ndarray  # [M] bool
    valid: np.ndarray  # [M] bool (False = padding)
    time: float
    sensor_idx: int
    scan_idx: int
    linear_velocity: np.ndarray  # [3]


def scan_to_raster_pts(
    points: np.ndarray, max_points: int, rng: Optional[np.random.Generator] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sensor-frame points [N, >=5] -> padded spherical query set
    (raster_pts [M,5], did_return [M], valid [M])."""
    rng = rng or np.random.default_rng(0)
    xyz = points[:, :3]
    rng_m = np.linalg.norm(xyz, axis=-1)
    azim = np.rad2deg(np.arctan2(xyz[:, 1], xyz[:, 0]))
    r2d = np.linalg.norm(xyz[:, :2], axis=-1)
    elev = np.rad2deg(np.arctan2(xyz[:, 2], np.clip(r2d, 1e-9, None)))
    intensity = points[:, 3] if points.shape[1] > 3 else np.full(len(points), 0.5)
    timediff = points[:, 4] if points.shape[1] > 4 else np.zeros(len(points))
    did_return = rng_m < 1e3  # DUMMY_DISTANCE missing points are non-returns

    pts = np.stack([azim, elev, rng_m, timediff, intensity], axis=-1).astype(np.float32)
    n = pts.shape[0]
    if n >= max_points:
        sel = rng.choice(n, size=max_points, replace=False)
        return pts[sel], did_return[sel], np.ones(max_points, dtype=bool)
    pad = max_points - n
    pts = np.concatenate([pts, np.zeros((pad, 5), dtype=np.float32)])
    did_return = np.concatenate([did_return, np.zeros(pad, dtype=bool)])
    valid = np.concatenate([np.ones(n, dtype=bool), np.zeros(pad, dtype=bool)])
    return pts, did_return, valid


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class FullImageLidarDataManager:
    """Full camera frames and full lidar scans by index."""

    def __init__(
        self,
        outputs: ADDataparserOutputs,
        config: Optional[FullImageLidarDataManagerConfig] = None,
        seed: int = 0,
    ):
        self.config = config or FullImageLidarDataManagerConfig()
        self.outputs = outputs
        self._rng = np.random.default_rng(seed)

        eval_cams = set(outputs.eval_camera_indices)
        self.train_cams = [i for i in range(len(outputs.images)) if i not in eval_cams]
        eval_lidars = set(outputs.eval_lidar_indices)
        self.train_lidars = [i for i in range(len(outputs.point_clouds)) if i not in eval_lidars]
        self._raster_cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def rng_state(self) -> dict:
        """Host sampler state, saved with a checkpoint so a resumed run draws
        the samples the uninterrupted run would have drawn."""
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state

    def _camera_sample(self, idx: int) -> CameraSample:
        cams = self.outputs.cameras
        img = self.outputs.images[idx]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        md = cams.metadata
        K = np.array(
            [
                [float(cams.fx[idx, 0]), 0.0, float(cams.cx[idx, 0])],
                [0.0, float(cams.fy[idx, 0]), float(cams.cy[idx, 0])],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )
        d = self.config.downscale_factor
        if d > 1:
            img = img[::d, ::d]
            K[:2] /= d
        return CameraSample(
            c2w=_np(cams.camera_to_worlds[idx]),
            K=K,
            width=img.shape[1],
            height=img.shape[0],
            image=img,
            time=float(cams.times[idx, 0]) if cams.times is not None else 0.0,
            sensor_idx=int(md["sensor_idxs"][idx, 0]) if "sensor_idxs" in md else 0,
            cam_idx=idx,
            linear_velocity=_np(md["velocities"][idx]) if "velocities" in md else np.zeros(3),
            rolling_shutter_time=float(md["rolling_shutter_time"][idx, 0]) if "rolling_shutter_time" in md else 0.0,
            time_to_center_pixel=float(md["time_to_center_pixel"][idx, 0]) if "time_to_center_pixel" in md else 0.0,
        )

    def _lidar_sample(self, idx: int) -> LidarSample:
        lids = self.outputs.lidars
        if idx not in self._raster_cache:
            self._raster_cache[idx] = scan_to_raster_pts(
                self.outputs.point_clouds[idx], self.config.max_lidar_points, self._rng
            )
        pts, did_return, valid = self._raster_cache[idx]
        md = lids.metadata
        return LidarSample(
            l2w=_np(lids.lidar_to_worlds[idx]),
            raster_pts=pts,
            did_return=did_return,
            valid=valid,
            time=float(lids.times[idx, 0]) if lids.times is not None else 0.0,
            sensor_idx=int(md["sensor_idxs"][idx, 0]) if "sensor_idxs" in md else 0,
            scan_idx=idx,
            linear_velocity=_np(md["velocities"][idx]) if "velocities" in md else np.zeros(3),
        )

    def next_train(self):
        """A random train camera frame (with probability `camera_fraction`) or
        lidar scan."""
        use_camera = self._rng.uniform() < self.config.camera_fraction or not self.train_lidars
        if use_camera and self.train_cams:
            return self._camera_sample(int(self._rng.choice(self.train_cams)))
        return self._lidar_sample(int(self._rng.choice(self.train_lidars)))

    def iter_train(self) -> Iterator:
        while True:
            yield self.next_train()

    def next_train_batch(self, n: int, rank: Optional[int] = None) -> List:
        """`n` same-modality samples for data-parallel training, drawn as the
        JAX package draws them: a camera batch takes cameras of the first
        pick's image shape (so that they stack), with replacement, as does a
        lidar batch. With `rank` only that sample is built (the others are
        None), but every draw is taken, a scan's first padding draw included,
        so the generators of all ranks stay equal."""
        use_camera = self._rng.uniform() < self.config.camera_fraction or not self.train_lidars
        if use_camera and self.train_cams:
            first = int(self._rng.choice(self.train_cams))
            shape = self.outputs.images[first].shape
            pool = [i for i in self.train_cams if self.outputs.images[i].shape == shape]
            idxs = [first] + [int(i) for i in self._rng.choice(pool, size=n - 1, replace=True)]
            return [self._camera_sample(i) if rank is None or r == rank else None for r, i in enumerate(idxs)]
        idxs = [int(i) for i in self._rng.choice(self.train_lidars, size=n, replace=True)]
        out = []
        for r, i in enumerate(idxs):
            sample = self._lidar_sample(i)  # builds (and caches) the scan's padded set from the shared generator
            out.append(sample if rank is None or r == rank else None)
        return out

    def all_seed_points(self, paint_topk: int = 4) -> np.ndarray:
        """World-frame accumulated point cloud for gaussian seeding, painted
        with camera RGB from the top-k nearest-in-time cameras. Returns
        [N, 8]: xyz, intensity, r, g, b, time."""
        cams = self.outputs.cameras
        cam_times = _np(cams.times[:, 0]) if cams.times is not None else np.zeros(len(self.outputs.images))
        c2w_all = _np(cams.camera_to_worlds)
        fx, fy, cx, cy = (_np(v[:, 0]) for v in (cams.fx, cams.fy, cams.cx, cams.cy))
        out = []
        for i in self.train_lidars:
            pc = self.outputs.point_clouds[i]
            l2w = _np(self.outputs.lidars.lidar_to_worlds[i])
            keep = np.linalg.norm(pc[:, :3], axis=-1) < 1e3  # drop missing-point dummies
            world = pc[keep, :3] @ l2w[:3, :3].T + l2w[:3, 3]
            t_scan = (
                float(_np(self.outputs.lidars.times[i]).reshape(-1)[0])
                if self.outputs.lidars.times is not None
                else 0.0
            )
            rgb = np.random.default_rng(i).uniform(size=(world.shape[0], 3)).astype(np.float32)
            k = min(paint_topk, len(cam_times))
            nearest = np.argsort(np.abs(cam_times - t_scan))[:k]
            # nearest camera painted LAST wins
            for ci in nearest[::-1]:
                c2w = np.eye(4, dtype=np.float64)
                c2w[:3] = c2w_all[ci]
                p_cam = (world - c2w[:3, 3]) @ c2w[:3, :3]  # = R^T (p - t)
                z = -p_cam[:, 2]  # camera looks down -z (OpenGL)
                valid = z > 0.1
                zs = np.clip(z, 0.1, None)
                u = (float(cx[ci]) + float(fx[ci]) * p_cam[:, 0] / zs).astype(int)
                v = (float(cy[ci]) - float(fy[ci]) * p_cam[:, 1] / zs).astype(int)
                img = self.outputs.images[ci]
                h, w = img.shape[:2]
                valid &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
                col = img[np.clip(v, 0, h - 1), np.clip(u, 0, w - 1)].astype(np.float32)
                if img.dtype == np.uint8:
                    col = col / 255.0
                rgb[valid] = col[valid]
            times = np.full((world.shape[0], 1), t_scan, dtype=np.float32)
            if pc.shape[1] > 4:  # per-point time offsets
                times = times + pc[keep, 4:5]
            out.append(
                np.concatenate([world, pc[keep, 3:4], rgb, times], axis=-1).astype(np.float32)
            )
        return np.concatenate(out) if out else np.zeros((0, 8), dtype=np.float32)
