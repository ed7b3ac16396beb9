"""AD datamanager (torch port of `neurad_tpu/data/datamanager.py`): fixed-shape
camera-patch + lidar-point training batches, and the eval side (full-image
camera rays at upsample-stride centres, full-scan lidar rays).

Every training batch has the same shapes:

  rays = [num_cam_patches * patch_size^2 camera rays] ++ [num_lidar_rays lidar rays]

A D x D ray patch supervises a (D * up)^2 pixel patch: camera rays sit at the
centres of up x up pixel blocks. Sampling is host-side numpy from
`np.random.default_rng(seed)`, drawn in the JAX package's order, so the same
seed gives the same batches in both packages. Images and point clouds stay on
the host; a batch's rays are generated on the datamanager's device.
`iter_train` prefetches batches from sampler threads, each with its own
generator forked from the datamanager's.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.cameras.cameras import generate_rays
from neurad_tpu_torch.cameras.lidars import generate_lidar_rays_from_points
from neurad_tpu_torch.core.structs import RayBundle
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs
from neurad_tpu_torch.utils import profiler


@dataclasses.dataclass
class ADDataManagerConfig:
    """Batch shape settings: 40 camera patches of 32 x 32 rays and 16,384 lidar
    rays by default. One camera ray stands for `rgb_upsample_factor`^2 pixels."""

    num_cam_patches: int = 40
    patch_size: int = 32  # rays per patch side
    num_lidar_rays: int = 16384
    rgb_upsample_factor: int = 3
    prefetch: int = 2
    num_workers: int = 2  # sampler threads feeding the prefetch queue


def extract_patches(images: np.ndarray, cam_idx: np.ndarray, r0: np.ndarray, c0: np.ndarray, gt: int) -> np.ndarray:
    """[B, gt, gt, 3] float32 patches (uint8 images normalised) from [N, H, W, 3]."""
    scale = 1.0 / 255.0 if images.dtype == np.uint8 else 1.0
    return np.stack([images[ci, r:r + gt, c:c + gt] for ci, r, c in zip(cam_idx, r0, c0)]).astype(np.float32) * scale


class ADDataManager:
    """Joint camera + lidar batch sampler over parsed outputs."""

    def __init__(self, outputs: ADDataparserOutputs, config: Optional[ADDataManagerConfig] = None, device="cuda",
                 seed: int = 0):
        self.config = config or ADDataManagerConfig()
        self.outputs = outputs
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)

        eval_cams = set(outputs.eval_camera_indices)
        self.train_cam_indices = np.array([i for i in range(len(outputs.images)) if i not in eval_cams], dtype=np.int64)
        # kept uint8 when the dataset provides uint8; normalised to float when used
        self.images = np.stack(outputs.images)  # [N, H, W, 3]
        self._img_scale = 1.0 / 255.0 if self.images.dtype == np.uint8 else 1.0

        eval_lidars = set(outputs.eval_lidar_indices)
        pts, scan_ids = [], []
        for i, pc in enumerate(outputs.point_clouds):
            if i not in eval_lidars:
                pts.append(pc)
                scan_ids.append(np.full(pc.shape[0], i, dtype=np.int64))
        self.points = np.concatenate(pts) if pts else np.zeros((0, 5), dtype=np.float32)
        self.point_scan_ids = np.concatenate(scan_ids) if scan_ids else np.zeros(0, dtype=np.int64)

        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, self.config.prefetch))
        self._threads: Optional[list] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    # the sampler's state, for an exact resume
    # ------------------------------------------------------------------

    def rng_state(self) -> dict:
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state

    @property
    def num_cam_rays(self) -> int:
        return self.config.num_cam_patches * self.config.patch_size**2

    @property
    def patch_shape(self) -> Tuple[int, int]:
        return (self.config.patch_size, self.config.patch_size)

    # ------------------------------------------------------------------
    # training batches
    # ------------------------------------------------------------------

    def next_train(self) -> Tuple[RayBundle, Dict[str, torch.Tensor]]:
        """One training batch: (RayBundle [camera rays .. lidar rays], batch dict)."""
        return self._sample_with_rng(self._rng)

    def _sample_with_rng(self, rng: np.random.Generator) -> Tuple[RayBundle, Dict[str, torch.Tensor]]:
        cfg = self.config
        d, up = cfg.patch_size, cfg.rgb_upsample_factor
        gt = d * up
        _, h, w = self.images.shape[:3]
        dev = self.device

        # camera patches
        cam_choice = rng.choice(self.train_cam_indices, size=cfg.num_cam_patches)
        r0 = rng.integers(0, h - gt + 1, size=cfg.num_cam_patches)
        c0 = rng.integers(0, w - gt + 1, size=cfg.num_cam_patches)
        k = np.arange(d) * up + up / 2.0  # ray pixel coords at the centre of each up x up block
        rows = r0[:, None, None] + k[None, :, None]  # [B, D, 1]
        cols = c0[:, None, None] + k[None, None, :]  # [B, 1, D]
        coords = np.stack(np.broadcast_arrays(rows, cols), axis=-1).reshape(-1, 2)  # [B * D * D, 2]
        cam_idx = np.repeat(cam_choice, d * d)
        cam_bundle = generate_rays(self.outputs.cameras, torch.from_numpy(cam_idx).to(dev),
                                   torch.from_numpy(coords.astype(np.float32)).to(dev))
        image = torch.from_numpy(extract_patches(self.images, cam_choice, r0, c0, gt)).to(dev)

        # lidar points
        if self.points.shape[0] > 0 and cfg.num_lidar_rays > 0:
            pt_idx = rng.integers(0, self.points.shape[0], size=cfg.num_lidar_rays)
            pts = self.points[pt_idx]
            scan = self.point_scan_ids[pt_idx]
            lidar_bundle = generate_lidar_rays_from_points(self.outputs.lidars, torch.from_numpy(scan).to(dev),
                                                           torch.from_numpy(pts).to(dev))
            bundle = _merge_cam_lidar(cam_bundle, lidar_bundle)
            batch = {
                "image": image,
                "distance": lidar_bundle.metadata["directions_norm"],
                "did_return": lidar_bundle.metadata["did_return"],
                "intensity": torch.from_numpy(np.ascontiguousarray(pts[:, 3:4])).to(dev),
            }
        else:
            bundle, batch = cam_bundle, {"image": image}
        return bundle, batch

    def iter_train(self) -> Iterator[Tuple[RayBundle, Dict[str, torch.Tensor]]]:
        """Batches from `num_workers` sampler threads through a queue of
        `prefetch` batches. Each thread draws from its own generator, seeded
        from the datamanager's (one draw per thread, as the JAX package does).
        `close()` stops the threads."""
        if self._threads is None:
            self._stop.clear()
            seeds = [int(self._rng.integers(0, 2**62)) + w for w in range(max(1, self.config.num_workers))]
            self._threads = [threading.Thread(target=self._worker, args=(seed,), daemon=True) for seed in seeds]
            for t in self._threads:
                t.start()
        while True:
            profiler.count("datamanager.gets", 1)
            profiler.count("datamanager.gets_waited", int(self._queue.empty()))  # no batch was ready
            item = self._queue.get()
            if isinstance(item, BaseException):
                raise item
            yield item

    def _worker(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        try:
            while not self._stop.is_set():
                item = self._sample_with_rng(rng)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as exc:  # the consumer raises it
            self._queue.put(exc)

    def close(self) -> None:
        """Stop the sampler threads of `iter_train` and wait for them."""
        if self._threads is None:
            return
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        self._threads = None
        while not self._queue.empty():
            self._queue.get_nowait()

    # ------------------------------------------------------------------
    # eval bundles
    # ------------------------------------------------------------------

    def eval_camera_bundle(self, cam_idx: int) -> Tuple[RayBundle, np.ndarray, Tuple[int, int]]:
        """Full-image eval rays at upsample-stride centres -> (bundle, gt image, feature-grid shape)."""
        up = self.config.rgb_upsample_factor
        h, w = self.images.shape[1:3]
        hs, ws = h // up, w // up
        k_r = torch.arange(hs, dtype=torch.float32, device=self.device) * up + up / 2.0
        k_c = torch.arange(ws, dtype=torch.float32, device=self.device) * up + up / 2.0
        rr, cc = torch.meshgrid(k_r, k_c, indexing="ij")
        coords = torch.stack([rr, cc], dim=-1).reshape(-1, 2)
        idx = torch.full((coords.shape[0],), cam_idx, dtype=torch.long, device=self.device)
        bundle = generate_rays(self.outputs.cameras, idx, coords)
        gt = self.images[cam_idx][: hs * up, : ws * up].astype(np.float32) * self._img_scale
        return bundle, gt, (hs, ws)

    def eval_lidar_bundle(self, scan_idx: int) -> Tuple[RayBundle, np.ndarray]:
        """Full-scan eval rays -> (bundle, points [N, 5])."""
        pts = self.outputs.point_clouds[scan_idx]
        idx = torch.full((pts.shape[0],), scan_idx, dtype=torch.long, device=self.device)
        bundle = generate_lidar_rays_from_points(self.outputs.lidars, idx, torch.from_numpy(pts).to(self.device))
        return bundle, pts


def _merge_cam_lidar(cam: RayBundle, lidar: RayBundle) -> RayBundle:
    """Camera rays before lidar rays, with aligned metadata (`sensor_idxs`,
    `directions_norm`, `did_return`, `is_lidar`) and nears / fars / times
    filled where a bundle lacks them."""
    n_cam, n_lidar = cam.origins.shape[0], lidar.origins.shape[0]
    dev = cam.origins.device
    cam_meta = {
        "sensor_idxs": cam.metadata.get("sensor_idxs", torch.zeros((n_cam, 1), dtype=torch.int32, device=dev)),
        "directions_norm": cam.metadata["directions_norm"],
        "did_return": torch.ones((n_cam, 1), dtype=torch.bool, device=dev),
        "is_lidar": torch.zeros((n_cam, 1), dtype=torch.bool, device=dev),
    }
    lid_meta = {
        "sensor_idxs": lidar.metadata.get("sensor_idxs", torch.ones((n_lidar, 1), dtype=torch.int32, device=dev)),
        "directions_norm": lidar.metadata["directions_norm"],
        "did_return": lidar.metadata["did_return"],
        "is_lidar": torch.ones((n_lidar, 1), dtype=torch.bool, device=dev),
    }

    def fill(b: RayBundle, meta: dict) -> RayBundle:
        n = b.origins.shape[0]
        return b.replace(
            metadata=meta,
            nears=b.nears if b.nears is not None else torch.zeros((n, 1), device=dev),
            fars=b.fars if b.fars is not None else torch.full((n, 1), 1e6, device=dev),
            times=b.times if b.times is not None else torch.zeros((n, 1), device=dev),
        )

    a, b = fill(cam, cam_meta), fill(lidar, lid_meta)
    cat = lambda x, y: torch.cat([x, y.to(x.dtype)], dim=0)
    return RayBundle(
        origins=cat(a.origins, b.origins), directions=cat(a.directions, b.directions),
        pixel_area=cat(a.pixel_area, b.pixel_area), camera_indices=cat(a.camera_indices, b.camera_indices),
        nears=cat(a.nears, b.nears), fars=cat(a.fars, b.fars), times=cat(a.times, b.times),
        metadata={k: cat(a.metadata[k], b.metadata[k]) for k in cam_meta},
    )
