"""Nerfacto and lidar nerfacto (torch port of `neurad_tpu/models/nerfacto.py`):
a hash-grid field and two hash-grid proposal density fields; the lidar variant
adds the DS-NeRF depth loss and gradient scaling by distance.

Random draws are explicit: `jitters` holds the proposal sampler's uniform
draws, one [R, 1] tensor per round (single jitter); without them the forward
is the deterministic eval path. `train=True` adds the sample histograms the
losses need; it is an argument, never module state.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from neurad_tpu_torch.cameras.camera_optimizers import CameraOptimizer
from neurad_tpu_torch.core.structs import RayBundle
from neurad_tpu_torch.fields.density_fields import HashMLPDensityField
from neurad_tpu_torch.fields.nerfacto_field import NerfactoField
from neurad_tpu_torch.model_components import losses as L
from neurad_tpu_torch.model_components.ray_samplers import UNIFORM_LIN_DISP_PIECEWISE, proposal_sampler
from neurad_tpu_torch.ops import rendering as R


def _mids(ray_samples) -> torch.Tensor:
    return (ray_samples.frustums.starts + ray_samples.frustums.ends) / 2.0


class NerfactoModel(nn.Module):
    """The nerfacto model. Arguments mirror the JAX model's attributes;
    `generator` seeds the hash tables (on its device)."""

    def __init__(
        self,
        aabb: Sequence[Sequence[float]],
        num_images: int = 1,
        num_proposal_samples: Tuple[int, ...] = (256, 96),
        num_nerf_samples: int = 48,
        interlevel_loss_mult: float = 1.0,
        distortion_loss_mult: float = 0.002,
        camera_opt_mode: str = "off",
        appearance_embedding_dim: int = 32,
        background_color: str = "last_sample",
        use_lidar_losses: bool = False,
        depth_sigma: float = 0.05,
        depth_loss_mult: float = 1e-3,
        use_gradient_scaling: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_proposal_samples = tuple(num_proposal_samples)
        self.num_nerf_samples = num_nerf_samples
        self.interlevel_loss_mult = interlevel_loss_mult
        self.distortion_loss_mult = distortion_loss_mult
        self.camera_opt_mode = camera_opt_mode
        self.background_color = background_color
        self.use_lidar_losses = use_lidar_losses
        self.depth_sigma = depth_sigma
        self.depth_loss_mult = depth_loss_mult
        self.use_gradient_scaling = use_gradient_scaling
        self.field = NerfactoField(aabb=aabb, num_images=num_images, appearance_embedding_dim=appearance_embedding_dim,
                                   generator=generator)
        self.proposal_0 = HashMLPDensityField(aabb=aabb, max_res=128, log2_hashmap_size=17, generator=generator)
        self.proposal_1 = HashMLPDensityField(aabb=aabb, max_res=256, log2_hashmap_size=17, generator=generator)
        self.camera_optimizer = CameraOptimizer(num_cameras=num_images, mode=camera_opt_mode)

    @property
    def proposal_networks(self) -> Tuple[HashMLPDensityField, HashMLPDensityField]:
        return (self.proposal_0, self.proposal_1)

    def get_outputs(self, ray_bundle: RayBundle, train: bool = False,
                    jitters: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        ray_bundle = self.camera_optimizer.apply_to_raybundle(ray_bundle)
        nears = ray_bundle.nears if ray_bundle.nears is not None else torch.full_like(ray_bundle.pixel_area, 0.05)
        fars = ray_bundle.fars if ray_bundle.fars is not None else torch.full_like(ray_bundle.pixel_area, 1000.0)
        ray_bundle = ray_bundle.replace(nears=nears, fars=fars)

        ray_samples, weights_list, samples_list = proposal_sampler(
            ray_bundle, [p.get_density for p in self.proposal_networks], self.num_proposal_samples,
            self.num_nerf_samples, spacing=UNIFORM_LIN_DISP_PIECEWISE, jitters=jitters,
        )
        field_out = self.field(ray_samples)
        mids = _mids(ray_samples)
        if self.use_gradient_scaling:
            density = L.gradient_scaling_by_distance_squared(field_out.density, mids)
            rgb_s = L.gradient_scaling_by_distance_squared(field_out.rgb, mids)
        else:
            density, rgb_s = field_out.density, field_out.rgb

        weights = R.render_weights_from_density(density, ray_samples.deltas)
        accumulation = R.accumulate_along_rays(weights)
        rgb = R.accumulate_along_rays(weights, rgb_s)
        if self.background_color == "last_sample":
            rgb = rgb + rgb_s[..., -1, :] * (1.0 - accumulation)
        outputs = {"rgb": rgb, "accumulation": accumulation, "depth": R.render_depth_expected(weights, mids)}
        for i, (pw, ps) in enumerate(zip(weights_list, samples_list)):
            outputs[f"prop_depth_{i}"] = R.render_depth_expected(pw, _mids(ps))
        if train:
            outputs["weights_list"] = list(weights_list) + [weights]
            outputs["sdist_list"] = [L.ray_samples_to_sdist(s.spacing_starts, s.spacing_ends)
                                     for s in list(samples_list) + [ray_samples]]
            if self.use_lidar_losses:
                outputs["ray_samples_mids"] = mids
                outputs["weights"] = weights
        return outputs

    def forward(self, ray_bundle: RayBundle, train: bool = False,
                jitters: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        return self.get_outputs(ray_bundle, train, jitters)

    def compute_losses(self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """rgb MSE, interlevel and distortion losses, the lidar variant's
        DS-NeRF depth loss where the batch has distances, the camera
        optimizer's regulariser; metrics: the detached terms and `psnr`."""
        loss_dict: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        if "image" in batch:
            rgb = outputs["rgb"]
            loss_dict["rgb_loss"] = torch.mean((batch["image"] - rgb) ** 2)
            metrics["psnr"] = L.psnr(rgb.detach(), batch["image"])
        if "weights_list" in outputs:
            loss_dict["interlevel_loss"] = self.interlevel_loss_mult * L.interlevel_loss(
                outputs["weights_list"], outputs["sdist_list"])
            loss_dict["distortion_loss"] = self.distortion_loss_mult * L.distortion_loss(
                outputs["weights_list"], outputs["sdist_list"])
        if self.use_lidar_losses and "distance" in batch and "weights" in outputs:
            mids = outputs["ray_samples_mids"]
            sigma = torch.tensor(self.depth_sigma, device=mids.device)
            loss_dict["depth_loss"] = self.depth_loss_mult * L.ds_nerf_depth_loss(
                outputs["weights"], batch["distance"], mids, mids * 0 + 1.0, sigma)
        if self.camera_opt_mode != "off":
            loss_dict["camera_opt_regularizer"] = self.camera_optimizer.regularization_loss()
        total = torch.zeros((), device=outputs["rgb"].device)
        for value in loss_dict.values():
            total = total + value
        metrics.update({k: v.detach() for k, v in loss_dict.items()})
        return total, metrics
