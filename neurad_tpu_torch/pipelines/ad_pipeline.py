"""AD pipeline (torch port of `neurad_tpu/pipelines/ad_pipeline.py`): builds
the NeuRAD model from parsed data and renders full sensors chunk-wise: eval
cameras and lidar scans, the viewer's camera frame and virtual lidar.

The pipeline owns its model, and the model owns the parameters (the JAX
pipeline carries them in a TrainState and takes it as an argument);
`init_state` re-draws them from a seed. Training (`loss_fn`, the train step,
VGG), the nerfacto models, the FID suite and the mesh-sharded eval branch are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.cameras.cameras import CameraType, Cameras, full_image_coords, generate_rays
from neurad_tpu_torch.core.structs import RayBundle, map_tensors
from neurad_tpu_torch.data.datamanager import ADDataManager, ADDataManagerConfig
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs
from neurad_tpu_torch.model_components.dynamic_actors import (
    ActorEdits,
    actor_data_from_trajectories,
    empty_actor_data,
)
from neurad_tpu_torch.models.neurad import NeuRADModel


@dataclasses.dataclass
class ADPipelineConfig:
    datamanager: ADDataManagerConfig = dataclasses.field(default_factory=ADDataManagerConfig)
    model: str = "neurad"
    model_overrides: dict = dataclasses.field(default_factory=dict)
    # rays per chunk of a full-sensor render: bounds the hash-lookup intermediates
    eval_chunk: int = 1 << 15
    seed: int = 0


class ADPipeline:
    """Builds model + datamanager from dataparser outputs."""

    def __init__(self, outputs: ADDataparserOutputs, config: Optional[ADPipelineConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.config = config or ADPipelineConfig()
        if self.config.model != "neurad":
            raise NotImplementedError(f"model {self.config.model!r} is not ported; only 'neurad' is")
        self.outputs = outputs
        self.datamanager = ADDataManager(outputs, self.config.datamanager, device=self.device)
        self.model = self._build_model(self.config.seed)

    def _build_model(self, seed: int) -> NeuRADModel:
        outputs = self.outputs
        actor_data = (
            actor_data_from_trajectories(outputs.trajectories) if outputs.trajectories else empty_actor_data()
        )
        model_kwargs = dict(
            actor_data=actor_data,
            static_scale=float(np.abs(np.asarray(outputs.scene_box.aabb)).max()),
            num_sensors=len(outputs.sensor_idx_to_name),
            duration=outputs.duration,
            num_train_images=len(outputs.images),
            rgb_upsample_factor=self.config.datamanager.rgb_upsample_factor,
        )
        model_kwargs.update(self.config.model_overrides)
        # the hash tables are drawn on the device from `generator`; the small dense layers on the host from
        # torch's default generator, seeded for the construction only
        generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = NeuRADModel(generator=generator, **model_kwargs)
        return model.to(self.device).eval()

    def init_state(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Re-draw the model's parameters from a seed (the configuration's by
        default) and return them (the model's state dict)."""
        fresh = self._build_model(self.config.seed if seed is None else seed)
        self.model.load_state_dict(fresh.state_dict())
        return self.model.state_dict()

    # ------------------------------------------------------------------
    # chunked feature-field render
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _chunked_nff(self, bundle: RayBundle, all_camera: bool, edits: Optional[ActorEdits] = None
                     ) -> Dict[str, torch.Tensor]:
        """The model's feature-field render over a flat bundle, `eval_chunk`
        rays at a time. `all_camera` decides the pixel-area scaling (a whole
        bundle is one modality at eval). The last chunk is padded with zero
        rays to the chunk's size, as the JAX pipeline pads it: the capacity of
        the compacted actor lookup depends on the chunk's size. Outputs are
        trimmed."""
        chunk = self.config.eval_chunk
        n = bundle.origins.shape[0]
        outs = []
        for start in range(0, n, chunk):
            piece = map_tensors(lambda x: x[start : start + chunk], bundle)
            m = piece.origins.shape[0]
            if m < chunk:
                piece = map_tensors(lambda x: torch.cat([x, x.new_zeros((chunk - m,) + x.shape[1:])], dim=0), piece)
            out = self.model.get_nff_outputs(piece, chunk if all_camera else 0, edits=edits)
            outs.append({k: v[:m] for k, v in out.items()})
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

    # ------------------------------------------------------------------
    # evaluation renders
    # ------------------------------------------------------------------

    @torch.no_grad()
    def render_eval_camera(self, cam_idx: int, edits: Optional[ActorEdits] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Full-image render -> (pred rgb [H', W', 3], gt rgb). `edits`: actor
        edits applied at render time."""
        bundle, gt, (hs, ws) = self.datamanager.eval_camera_bundle(cam_idx)
        nff = self._chunked_nff(bundle, all_camera=True, edits=edits)
        rgb = self.model.decode_features(nff["features"], (hs, ws), hs * ws)[0]
        return rgb[0].cpu().numpy(), gt

    @torch.no_grad()
    def render_eval_lidar(self, scan_idx: int) -> Dict[str, np.ndarray]:
        bundle, pts = self.datamanager.eval_lidar_bundle(scan_idx)
        nff = self._chunked_nff(bundle, all_camera=False)
        _, intensity, ray_drop = self.model.decode_features(nff["features"], (1, 1), 0)
        host = lambda x: x.cpu().numpy()
        return {
            "depth": host(nff["depth"]),
            "intensity": host(intensity),
            "ray_drop_logits": host(ray_drop),
            "gt_distance": host(bundle.metadata["directions_norm"]),
            "gt_intensity": pts[:, 3:4],
            "did_return": host(bundle.metadata["did_return"]),
            "origins": host(bundle.origins),
            "directions": host(bundle.directions),
        }

    # ------------------------------------------------------------------
    # viewer renders
    # ------------------------------------------------------------------

    @staticmethod
    def _viewer_edits(edits_vec) -> ActorEdits:
        """(lateral, longitudinal, rotation, height) -> ActorEdits of every
        actor; a fifth element (another model's) is ignored."""
        ev = [0.0] * 4 if edits_vec is None else [float(v) for v in np.asarray(edits_vec, np.float32)[:4]]
        return ActorEdits(lateral=ev[0], longitudinal=ev[1], rotation=ev[2], height=ev[3], index=-1)

    @torch.no_grad()
    def render_viewer_image(self, c2w: np.ndarray, width: int, height: int, time: float, edits_vec=None) -> np.ndarray:
        """Full-frame render for the live viewer from a free camera (focal
        0.7 * width, one ray per pixel) -> [height * up, width * up, 3]."""
        dev = self.device
        focal = 0.7 * width
        full = lambda v, dtype=torch.float32: torch.full((1, 1), v, dtype=dtype, device=dev)
        cams = Cameras(
            camera_to_worlds=torch.as_tensor(np.array(c2w, np.float32), device=dev)[None],
            fx=full(focal), fy=full(focal), cx=full(width / 2.0), cy=full(height / 2.0),
            width=full(width, torch.int32), height=full(height, torch.int32),
            camera_type=full(int(CameraType.PERSPECTIVE), torch.int32),
            times=full(float(time)),
        )
        coords = full_image_coords(height, width, device=dev)
        bundle = generate_rays(cams, torch.zeros(coords.shape[0], dtype=torch.long, device=dev), coords)
        nff = self.model.get_nff_outputs(bundle, bundle.origins.shape[0], edits=self._viewer_edits(edits_vec))
        rgb = self.model.decode_features(nff["features"], (height, width), height * width)[0]
        return rgb[0].cpu().numpy()

    @torch.no_grad()
    def render_virtual_lidar(
        self, origin: np.ndarray, time: float, channels: int = 32, azim_res_deg: float = 1.0, fov_up: float = 5.0,
        fov_down: float = -15.0, drop_threshold: float = 0.5, edits_vec=None,
    ) -> np.ndarray:
        """Virtual-lidar point cloud for the viewer: a spherical scan at
        `origin` rendered through the model; points whose predicted ray-drop
        probability is below the threshold are kept -> [N, 4] (world xyz +
        intensity)."""
        elev = np.deg2rad(np.linspace(fov_down, fov_up, channels))
        azim = np.deg2rad(np.arange(-180.0, 180.0, azim_res_deg))
        el, azm = np.meshgrid(elev, azim, indexing="ij")
        dirs = np.stack(
            [np.cos(el) * np.cos(azm), np.cos(el) * np.sin(azm), np.sin(el)], axis=-1
        ).reshape(-1, 3).astype(np.float32)
        n, dev = dirs.shape[0], self.device
        bundle = RayBundle(
            origins=torch.as_tensor(np.asarray(origin, np.float32), device=dev).expand(n, 3),
            directions=torch.from_numpy(dirs).to(dev),
            pixel_area=torch.full((n, 1), 1e-6, device=dev),
            camera_indices=torch.zeros((n, 1), dtype=torch.long, device=dev),
            times=torch.full((n, 1), float(time), device=dev),
            metadata={
                "directions_norm": torch.ones((n, 1), device=dev),
                "is_lidar": torch.ones((n, 1), dtype=torch.bool, device=dev),
                "sensor_idxs": torch.zeros((n, 1), dtype=torch.long, device=dev),
            },
        )
        nff = self.model.get_nff_outputs(bundle, 0, edits=self._viewer_edits(edits_vec))
        _, intensity, ray_drop = self.model.decode_features(nff["features"], (1, 1), 0)
        depth, intensity = nff["depth"].cpu().numpy(), intensity.cpu().numpy()
        keep = 1.0 / (1.0 + np.exp(-ray_drop.cpu().numpy()[:, 0])) < drop_threshold
        pts = np.asarray(origin)[None] + dirs * depth
        return np.concatenate([pts, intensity], axis=-1)[keep]
