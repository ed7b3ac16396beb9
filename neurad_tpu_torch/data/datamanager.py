"""AD datamanager (torch port of `neurad_tpu/data/datamanager.py`): the eval
side, full-image camera rays at upsample-stride centres and full-scan lidar
rays. The training sampler (camera patches + lidar points per batch, the
prefetch threads) is not ported yet.

Images and point clouds stay on the host; a bundle's rays are generated on
the datamanager's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.cameras.cameras import generate_rays
from neurad_tpu_torch.cameras.lidars import generate_lidar_rays_from_points
from neurad_tpu_torch.core.structs import RayBundle
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs


@dataclasses.dataclass
class ADDataManagerConfig:
    """One camera ray stands for `rgb_upsample_factor`^2 pixels. (The training
    batch's shape settings arrive with the training sampler.)"""

    rgb_upsample_factor: int = 3


class ADDataManager:
    """Camera + lidar rays over parsed outputs."""

    def __init__(self, outputs: ADDataparserOutputs, config: Optional[ADDataManagerConfig] = None, device="cuda"):
        self.config = config or ADDataManagerConfig()
        self.outputs = outputs
        self.device = resolve_device(device)
        # kept uint8 when the dataset provides uint8; normalised to float when used
        self.images = np.stack(outputs.images)  # [N, H, W, 3]
        self._img_scale = 1.0 / 255.0 if self.images.dtype == np.uint8 else 1.0

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
