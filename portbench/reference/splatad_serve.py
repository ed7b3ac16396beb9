"""SplatAD's camera request in plain PyTorch: what `ClosedLoopState.render_image`
returns for a pose, a time and the actors' trajectories (the camera's
velocity and rolling shutter included), computed by the frozen copy in
`port/` from the benchmark's scene and gaussians: projection, binning into
16-pixel tiles of `max_per_tile` slots, the camera composite's plain version
and the RGB decoder.

`precision` "stated": as the configuration states (the gaussians, the
projection and the composite in fp32, the decoder's convolutions in bf16 and
its head in fp32): the reference; "fp8": the decoder's convolutions on fp8
operands and the gaussians' parameters rounded to bf16 (the control: one
step below what the configuration states for each).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from portbench.reference.common import camera_index, patched_cameras, set_actor_trajectories, set_precision
from portbench.reference.port.model_components.dynamic_actors import actor_data_from_trajectories
from portbench.reference.port.models.splatad import GaussianInit, SplatADConfig, SplatADModel

GAUSSIAN_KEYS = ("means", "scales", "quats", "features", "opacities")


class SplatADServe:
    def __init__(self, serve: dict, scene, weights: Dict[str, torch.Tensor], gauss_ids: torch.Tensor, device,
                 precision: str = "stated"):
        self.scene, self.device = scene, torch.device(device)
        cap = int(weights["means"].shape[0])
        feature_dim = int(weights["features"].shape[1])
        init = GaussianInit(
            means=np.zeros((cap, 3), np.float32), scales_log=np.zeros((cap, 3), np.float32),
            quats=np.zeros((cap, 4), np.float32), features=np.zeros((cap, feature_dim), np.float32),
            opacities_logit=np.zeros((cap,), np.float32), ids=gauss_ids.cpu().numpy().astype(np.int32),
        )
        config = SplatADConfig(**serve.get("model", {}))
        self.model = SplatADModel(
            init_data=init, actor_data=actor_data_from_trajectories(scene.trajectories), config=config,
            num_sensors=len(scene.sensor_idx_to_name), num_train_images=len(scene.images),
            generator=torch.Generator().manual_seed(0),
        ).to(self.device).eval()
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, w in weights.items():
                params[name].copy_(w)
            if precision == "fp8":
                for k in GAUSSIAN_KEYS:
                    params[k].copy_(params[k].to(torch.bfloat16).float())
        if precision != "stated":
            set_precision(self.model, precision)

    @torch.inference_mode()
    def render(self, pose: np.ndarray, time: float, camera_name: str, actors: Sequence[dict]) -> np.ndarray:
        """The request's image [H, W, 3] on the host."""
        set_actor_trajectories(self.model.actors, actors, self.device)
        cam_idx = camera_index(self.scene, camera_name)
        cams = patched_cameras(self.scene.cameras, cam_idx, pose, time)
        md = cams.metadata
        K = np.array([[float(cams.fx[cam_idx, 0]), 0.0, float(cams.cx[cam_idx, 0])],
                      [0.0, float(cams.fy[cam_idx, 0]), float(cams.cy[cam_idx, 0])],
                      [0.0, 0.0, 1.0]], dtype=np.float32)
        out = self.model.get_camera_outputs(
            cams.camera_to_worlds[cam_idx].numpy(), K, int(cams.width[cam_idx, 0]), int(cams.height[cam_idx, 0]),
            float(cams.times[cam_idx, 0]) if cams.times is not None else 0.0,
            int(md["sensor_idxs"][cam_idx, 0]) if "sensor_idxs" in md else 0, cam_idx,
            cam_linear_vel=md["velocities"][cam_idx].numpy() if "velocities" in md else np.zeros(3),
            rolling_shutter_time=float(md["rolling_shutter_time"][cam_idx, 0]) if "rolling_shutter_time" in md else 0.0,
            time_to_center_pixel=float(md["time_to_center_pixel"][cam_idx, 0]) if "time_to_center_pixel" in md else 0.0,
        )
        return out["rgb"].float().cpu().numpy()
