"""SplatAD pipeline (torch port of `neurad_tpu/pipelines/splatad_pipeline.py`,
the serving part): scene seeding, the model, and the eval/viewer renders.

The pipeline owns its model; its parameters are the model's state dict (the
JAX pipeline carries them in a TrainState). Training steps, densification and
checkpoints wait for slice 2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs
from neurad_tpu_torch.data.full_image_datamanager import (
    FullImageLidarDataManager,
    FullImageLidarDataManagerConfig,
)
from neurad_tpu_torch.model_components.dynamic_actors import (
    ActorEdits,
    actor_data_from_trajectories,
    empty_actor_data,
)
from neurad_tpu_torch.models.splatad import SplatADConfig, SplatADModel, seed_gaussians


@dataclasses.dataclass
class SplatADPipelineConfig:
    datamanager: FullImageLidarDataManagerConfig = dataclasses.field(
        default_factory=FullImageLidarDataManagerConfig
    )
    model: SplatADConfig = SplatADConfig()
    cap_max: int = 500_000
    seed: int = 0


class SplatADPipeline:
    def __init__(
        self,
        outputs: ADDataparserOutputs,
        config: Optional[SplatADPipelineConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or SplatADPipelineConfig()
        self.outputs = outputs
        self.datamanager = FullImageLidarDataManager(outputs, self.config.datamanager, seed=self.config.seed)

        seed_pts = self.datamanager.all_seed_points()
        actor_data = (
            actor_data_from_trajectories(outputs.trajectories) if outputs.trajectories else empty_actor_data()
        )
        init = seed_gaussians(
            seed_pts,
            outputs.trajectories,
            cap_max=self.config.cap_max,
            feature_dim=self.config.model.feature_dim,
            scene_aabb=outputs.scene_box.aabb.numpy(),
            seed=self.config.seed,
        )
        self.model = SplatADModel(
            init_data=init,
            actor_data=actor_data,
            config=self.config.model,
            num_sensors=len(outputs.sensor_idx_to_name),
            num_train_images=len(outputs.images),
            generator=torch.Generator().manual_seed(self.config.seed),
        ).to(self.device)
        self.model.eval()

    @torch.inference_mode()
    def render_eval_camera(self, cam_idx: int, edits: Optional[ActorEdits] = None):
        """Full-image render -> (pred rgb [H, W, 3], gt rgb), numpy."""
        s = self.datamanager._camera_sample(cam_idx)
        out = self.model.get_camera_outputs(
            s.c2w, s.K, s.width, s.height, s.time, s.sensor_idx, s.cam_idx,
            cam_linear_vel=s.linear_velocity,
            rolling_shutter_time=s.rolling_shutter_time,
            time_to_center_pixel=s.time_to_center_pixel,
            edits=edits,
        )
        return out["rgb"].cpu().numpy(), s.image

    @torch.inference_mode()
    def render_eval_lidar(self, scan_idx: int) -> Dict[str, np.ndarray]:
        """Lidar scan render with the ray pipeline's output keys
        (depth/intensity/ray_drop_logits/gt_*/origins/directions)."""
        s = self.datamanager._lidar_sample(scan_idx)
        out = self.model.get_lidar_outputs(
            s.l2w, s.raster_pts, s.time, s.sensor_idx, lidar_linear_vel=s.linear_velocity
        )
        azim = np.deg2rad(s.raster_pts[:, 0])
        elev = np.deg2rad(s.raster_pts[:, 1])
        dirs_l = np.stack([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)], axis=-1)
        l2w = np.asarray(s.l2w)
        dirs = dirs_l @ l2w[:3, :3].T
        return {
            "depth": out["depth"].cpu().numpy(),
            "intensity": out["intensity"].cpu().numpy(),
            "ray_drop_logits": out["ray_drop_logits"].cpu().numpy(),
            "gt_distance": s.raster_pts[:, 2:3],
            "gt_intensity": s.raster_pts[:, 4:5],
            "did_return": np.asarray(s.did_return & s.valid)[:, None],
            "origins": np.broadcast_to(l2w[:3, 3], dirs.shape),
            "directions": dirs,
        }

    @torch.inference_mode()
    def render_viewer_image(
        self, c2w: np.ndarray, width: int, height: int, time: float, edits_vec=None
    ) -> np.ndarray:
        """Viewer render at an arbitrary pose: focal 0.7*width, sensor 0, and
        `edits_vec` = (lateral, longitudinal, rotation, height, rolling-shutter
        time), missing entries zero."""
        ev = np.zeros(5, np.float32)
        if edits_vec is not None:
            vals = np.asarray(edits_vec, np.float32)[:5]
            ev[: len(vals)] = vals
        focal = 0.7 * width
        K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]], np.float32)
        edits = ActorEdits(lateral=float(ev[0]), longitudinal=float(ev[1]), rotation=float(ev[2]), height=float(ev[3]))
        out = self.model.get_camera_outputs(
            np.asarray(c2w, np.float32)[:3], K, width, height, float(time), 0, 0,
            rolling_shutter_time=float(ev[4]),
            edits=edits,
        )
        return out["rgb"].cpu().numpy()
