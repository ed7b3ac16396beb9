"""NeuRAD's camera request in plain PyTorch: what `ClosedLoopState.render_image`
returns for a pose, a time and the actors' trajectories, computed by the frozen
copy in `port/` from the benchmark's scene and weights.

`precision` "stated": the precision that the configuration states (its
model block's `compute_fp32`, and the backends' TF32 flags as the check
leaves them: PyTorch's defaults): the reference; or the control, one step
below (`common.set_precision`): "tf32" for an fp32 configuration, "fp8" for
a bf16 one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference.common import (camera_index, patched_cameras, precision_context, set_actor_trajectories,
                                        set_precision)
from portbench.reference.port.cameras.cameras import generate_rays
from portbench.reference.port.core.structs import map_tensors
from portbench.reference.port.model_components.dynamic_actors import actor_data_from_trajectories
from portbench.reference.port.models.neurad import NeuRADModel


class NeuRADServe:
    def __init__(self, serve: dict, scene, weights: Dict[str, torch.Tensor], device, precision: str = "stated",
                 model: Optional[dict] = None):
        self.scene, self.device = scene, torch.device(device)
        self.eval_chunk = int(serve["eval_chunk"])
        self.up = int(serve["rgb_upsample_factor"])
        kwargs = dict(
            actor_data=actor_data_from_trajectories(scene.trajectories),
            static_scale=float(np.abs(np.asarray(scene.scene_box.aabb)).max()),
            num_sensors=len(scene.sensor_idx_to_name),
            duration=scene.duration,
            num_train_images=len(scene.images),
            rgb_upsample_factor=self.up,
        )
        kwargs.update(model or {})
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = NeuRADModel(generator=torch.Generator(device=self.device).manual_seed(0), **kwargs)
        self.model = model.to(self.device).eval()
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, w in weights.items():
                params[name].copy_(w)
        self.precision = precision
        if precision != "stated":
            set_precision(self.model, precision)

    @torch.no_grad()
    def render(self, pose: np.ndarray, time: float, camera_name: str, actors: Sequence[dict]) -> np.ndarray:
        """The request's image [H, W, 3] on the host."""
        set_actor_trajectories(self.model.actors, actors, self.device)
        cam_idx = camera_index(self.scene, camera_name)
        cams = patched_cameras(self.scene.cameras, cam_idx, pose, time)
        h, w = int(cams.height[cam_idx, 0]), int(cams.width[cam_idx, 0])
        hs, ws = h // self.up, w // self.up
        dev = self.device
        rows = torch.arange(hs, dtype=torch.float32, device=dev) * self.up + self.up / 2.0
        cols = torch.arange(ws, dtype=torch.float32, device=dev) * self.up + self.up / 2.0
        rr, cc = torch.meshgrid(rows, cols, indexing="ij")
        coords = torch.stack([rr, cc], dim=-1).reshape(-1, 2)
        idx = torch.full((coords.shape[0],), cam_idx, dtype=torch.long, device=dev)
        bundle = generate_rays(cams, idx, coords)
        with precision_context(self.precision):
            features = self._features(bundle)
            rgb = self.model.decode_features(features, (hs, ws), hs * ws)[0]
        return rgb[0].float().cpu().numpy()

    def _features(self, bundle) -> torch.Tensor:
        """The feature-field render in chunks of `eval_chunk` rays, the last
        padded with zero rays (the compacted actor lookup's capacity follows
        the chunk's size)."""
        chunk, n = self.eval_chunk, bundle.origins.shape[0]
        outs: List[torch.Tensor] = []
        for start in range(0, n, chunk):
            piece = map_tensors(lambda x: x[start: start + chunk], bundle)
            m = piece.origins.shape[0]
            if m < chunk:
                piece = map_tensors(lambda x: torch.cat([x, x.new_zeros((chunk - m,) + x.shape[1:])], dim=0), piece)
            out = self.model.get_nff_outputs(piece, chunk)
            outs.append(out["features"][:m])
        return torch.cat(outs, dim=0)
