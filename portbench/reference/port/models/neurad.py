"""NeuRAD: neural feature fields for dynamic AD scenes, camera + lidar (torch
port of `neurad_tpu/models/neurad.py`): the forward, the per-ray train-time
terms (interlevel, distortion, carving) and the training loss.

The ray batch has a static layout: the first `num_cam_rays` rays are camera
rays (B patches of D x D), the rest are lidar rays; metadata `is_lidar`, where
present, decides per ray instead. Random draws (sampler jitter, actor flip)
are explicit tensors; without them the forward is the deterministic eval path.
`train=True` adds the per-ray loss terms to the outputs; it is an argument,
never module state.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from portbench.reference.port.cameras.camera_optimizers import CameraOptimizer
from portbench.reference.port.core.structs import Frustums, RayBundle, RaySamples
from portbench.reference.port.fields.mlp import MLP
from portbench.reference.port.fields.neurad_encoding import ActorSettings, StaticSettings
from portbench.reference.port.fields.neurad_field import MLPProposalField, NeuRADField, NeuRADProposalField
from portbench.reference.port.model_components import losses as L
from portbench.reference.port.model_components.cnns import RGBDecoderCNN
from portbench.reference.port.model_components.dynamic_actors import ActorData, DynamicActors
from portbench.reference.port.model_components.perceptual import Vgg19Slices, vgg_perceptual_loss
from portbench.reference.port.model_components.ray_samplers import power_spacing, proposal_sampler
from portbench.reference.port.ops import rendering as R

EPS = 1e-7


class LossSettings(NamedTuple):
    """Loss multipliers."""

    vgg_mult: float = 0.05
    rgb_mult: float = 5.0
    depth_mult: float = 0.01
    intensity_mult: float = 0.1
    carving_mult: float = 0.01
    carving_epsilon: float = 0.1
    quantile_threshold: float = 0.95
    interlevel_loss_mult: float = 0.001
    distortion_loss_mult: float = 0.002
    non_return_lidar_distance: float = 150.0
    non_return_loss_mult: float = 0.1
    ray_drop_loss_mult: float = 0.01
    prop_lidar_loss_mult: float = 0.1


class MLPProposalSettings(NamedTuple):
    """Capacity knobs of the MLP proposal field."""

    num_freqs: int = 10
    num_time_freqs: int = 4
    time_scale: float = 0.25
    hidden_dim: int = 128
    num_layers: int = 2


class SamplingSettings(NamedTuple):
    """Proposal sampling settings."""

    single_jitter: bool = True
    num_proposal_samples: Tuple[int, ...] = (128, 64)
    num_nerf_samples: int = 32
    power_lambda: float = -1.0
    power_scaling: float = 0.1
    sky_distance: float = 20000.0


_PROPOSAL_STATIC = StaticSettings(log2_hashmap_size=20, num_levels=6, max_res=4096, base_res=128, hashgrid_dim=1)


class NeuRADModel(nn.Module):
    """The NeuRAD model. Arguments mirror the JAX model's attributes;
    `actor_data` carries trajectories (from the dataparser), `static_scale` is
    the scene box's extent. `generator` seeds the hash tables."""

    def __init__(
        self,
        actor_data: ActorData,
        static_scale: float,
        num_sensors: int = 1,
        duration: float = 10.0,
        num_train_images: int = 1,
        loss: LossSettings = LossSettings(),
        sampling: SamplingSettings = SamplingSettings(),
        field_static: StaticSettings = StaticSettings(),
        field_actor: ActorSettings = ActorSettings(flip_prob=0.25),
        proposal_static: Tuple[StaticSettings, ...] = (_PROPOSAL_STATIC, _PROPOSAL_STATIC),
        proposal_actor: ActorSettings = ActorSettings(
            log2_hashmap_size=15, num_levels=4, base_res=64, max_res=1024, hashgrid_dim=1
        ),
        # "mlp" (fourier + MLP density, matmul-only), "hashgrid" (a 6-level hash proposal per round) or
        # "hashgrid-shared" (one hash proposal queried by every round)
        proposal_mode: str = "mlp",
        proposal_mlp: MLPProposalSettings = MLPProposalSettings(),
        # fp32 end to end: fp32 hash-table reads, fp32 field MLPs and decoders (the default is bf16)
        compute_fp32: bool = False,
        appearance_dim: int = 16,
        use_temporal_appearance: bool = True,
        temporal_appearance_freq: float = 1.0,
        rgb_upsample_factor: int = 3,
        rgb_hidden_dim: int = 32,
        rgb_decoder_norm: str = "group",
        nff_out_dim: int = 32,
        use_sdf: bool = True,
        camera_opt_mode: str = "off",
        camera_opt_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
        camera_opt_trans_penalty: Tuple[float, ...] = (1e-2, 1e-2, 1e-2),
        optimize_trajectories: bool = True,
        max_actors_per_ray: int = 4,
        # capacity divisor of the compacted actor lookup (0 disables it; outputs then do not depend on the
        # eval chunk's size)
        actor_compaction: int = 8,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if proposal_mode not in ("mlp", "hashgrid", "hashgrid-shared"):
            raise ValueError(f"unknown proposal_mode {proposal_mode!r}")
        self.static_scale = static_scale
        self.duration = duration
        self.loss = loss
        self.camera_opt_mode = camera_opt_mode
        self.sampling = sampling
        self.appearance_dim = appearance_dim
        self.use_temporal_appearance = use_temporal_appearance
        self.temporal_appearance_freq = temporal_appearance_freq
        self.rgb_upsample_factor = rgb_upsample_factor
        self.use_sdf = use_sdf
        self.nff_out_dim = nff_out_dim
        compute_dtype = None if compute_fp32 else torch.bfloat16

        self.actors = DynamicActors(actor_data, optimize_trajectories=optimize_trajectories)
        if compute_fp32:
            field_static = field_static._replace(gather_f32=True)
            field_actor = field_actor._replace(gather_f32=True)
        self.field = NeuRADField(
            actors=self.actors, static_scale=static_scale, static=field_static, actor=field_actor,
            nff_out_dim=nff_out_dim, use_sdf=use_sdf, max_actors_per_ray=max_actors_per_ray,
            actor_compaction=actor_compaction, compute_dtype=compute_dtype, generator=generator,
        )
        hash_proposal = lambda static: NeuRADProposalField(
            actors=self.actors, static_scale=static_scale, static=static, actor=proposal_actor,
            max_actors_per_ray=max_actors_per_ray, actor_compaction=actor_compaction, generator=generator,
        )
        if proposal_mode == "mlp":
            fields = [MLPProposalField(static_scale, generator=generator, **proposal_mlp._asdict())
                      for _ in proposal_static]
        elif proposal_mode == "hashgrid-shared":
            fields = [hash_proposal(proposal_static[0])]
        else:
            fields = [hash_proposal(s) for s in proposal_static]
        self.proposal_fields = nn.ModuleList(fields)

        self.camera_optimizer = CameraOptimizer(
            num_cameras=num_train_images, mode=camera_opt_mode, weights=camera_opt_weights,
            trans_l2_penalty=camera_opt_trans_penalty,
        )
        num_embeds = num_sensors * (self._num_embeds_per_sensor if use_temporal_appearance else 1)
        self.appearance_embedding = nn.Embedding(num_embeds, appearance_dim) if appearance_dim > 0 else None
        self.rgb_decoder = RGBDecoderCNN(
            nff_out_dim + appearance_dim, hidden_dim=rgb_hidden_dim, upsample_factor=rgb_upsample_factor,
            norm=rgb_decoder_norm, compute_dtype=compute_dtype,
        )
        self.lidar_decoder = MLP(nff_out_dim + appearance_dim, 2, num_layers=3, layer_width=32,
                                 compute_dtype=compute_dtype)

    @property
    def num_proposal_rounds(self) -> int:
        """The proposal sampler's rounds before the field's: one a count of
        `sampling.num_proposal_samples`."""
        return len(self.sampling.num_proposal_samples)

    @property
    def _num_embeds_per_sensor(self) -> int:
        return max(1, math.ceil(self.duration * self.temporal_appearance_freq))

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def forward(self, ray_bundle: RayBundle, patch_size: Tuple[int, int] = (1, 1), num_cam_rays: int = 0,
                **kwargs) -> Dict[str, torch.Tensor]:
        return self.get_outputs(ray_bundle, patch_size, num_cam_rays, **kwargs)

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        patch_size: Tuple[int, int] = (1, 1),
        num_cam_rays: int = 0,
        jitters: Optional[Sequence[torch.Tensor]] = None,
        flip_draw: Optional[torch.Tensor] = None,
        intensity_for_cam: bool = False,
        edits=None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Full forward: the feature-field render, then the modality decoders.
        The first `num_cam_rays` rays are camera rays laid out as patches of
        `patch_size`; the remainder are lidar rays."""
        outputs = self.get_nff_outputs(ray_bundle, num_cam_rays, jitters=jitters, flip_draw=flip_draw, edits=edits,
                                       train=train)
        features = outputs.pop("features")
        rgb, intensity, ray_drop_logits = self.decode_features(
            features, patch_size, num_cam_rays, intensity_for_cam=intensity_for_cam, train=train
        )
        if rgb is not None:
            outputs["rgb"] = rgb
        if intensity is not None:
            outputs["intensity"] = intensity
            outputs["ray_drop_logits"] = ray_drop_logits
        return outputs

    def decode_features(
        self, features: torch.Tensor, patch_size: Tuple[int, int], num_cam_rays: int, intensity_for_cam: bool = False,
        train: bool = False,
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Static-split modality decoding -> (rgb [B, D*up, D*up, 3], intensity,
        ray-drop logits). `train`: a batch-norm decoder normalises by the batch
        and updates its running averages."""
        cam_features = features[:num_cam_rays]
        lidar_features = features if intensity_for_cam else features[num_cam_rays:]

        intensity = ray_drop_logit = None
        if lidar_features.shape[0] > 0:
            out = self.lidar_decoder(lidar_features)
            intensity, ray_drop_logit = torch.sigmoid(out[..., :1]), out[..., 1:]

        rgb = None
        if cam_features.shape[0] > 0:
            patches = cam_features.reshape(-1, *patch_size, cam_features.shape[-1])
            rgb = self.rgb_decoder(patches, train)
        return rgb, intensity, ray_drop_logit

    def get_nff_outputs(
        self,
        ray_bundle: RayBundle,
        num_cam_rays: int = 0,
        jitters: Optional[Sequence[torch.Tensor]] = None,
        flip_draw: Optional[torch.Tensor] = None,
        edits=None,
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """The neural-feature-field render. Every output is per ray ([R, ...]),
        the train-time loss terms (`train`) included, so the method chunks
        over rays at the pipeline level."""
        ray_bundle = self.camera_optimizer.apply_to_raybundle(ray_bundle)
        ray_bundle = self._scale_pixel_area(ray_bundle, num_cam_rays)
        ray_samples, prop_weights, prop_samples = self._get_ray_samples(ray_bundle, jitters, edits=edits)

        field_out = self.field(ray_samples, flip_draw=flip_draw, edits=edits)

        if self.use_sdf:
            weights, _ = R.render_weights_from_alpha(field_out.alphas)
        else:
            weights = R.render_weights_from_density(field_out.density, ray_samples.deltas)
        weights = weights[..., 0]  # [R, S]
        accumulation = torch.sum(weights, dim=-1, keepdim=True)  # [R, 1]

        # leftover accumulation goes onto the sky sample
        weights = torch.cat([weights[..., :-1], weights[..., -1:] + 1.0 - accumulation], dim=-1)
        weights = weights[..., None]  # [R, S, 1]
        features = R.accumulate_along_rays(weights, field_out.features)  # [R, F]
        if self.appearance_dim > 0:
            features = torch.cat([features, self._get_appearance_embedding(ray_bundle, features)], dim=-1)

        # the sky sample is left out of the depth
        w_nosky = weights[..., :-1, :]
        mids = (ray_samples.frustums.starts + ray_samples.frustums.ends) / 2.0
        depth = R.accumulate_along_rays(w_nosky, mids[..., :-1, :])

        outputs: Dict[str, torch.Tensor] = {"features": features, "depth": depth, "accumulation": accumulation}
        for i, (pw, ps) in enumerate(zip(prop_weights, prop_samples)):
            pmids = (ps.frustums.starts + ps.frustums.ends) / 2.0
            outputs[f"prop_depth_{i}"] = R.accumulate_along_rays(pw, pmids)

        if train:
            # per-ray interlevel + distortion over the sample histograms
            weights_list = list(prop_weights) + [w_nosky]
            sdist_list = [L.ray_samples_to_sdist(s.spacing_starts, s.spacing_ends) for s in prop_samples] + [
                L.ray_samples_to_sdist(ray_samples.spacing_starts[..., :-1, :], ray_samples.spacing_ends[..., :-1, :])
            ]
            outputs["interlevel_per_ray"] = L.zipnerf_interlevel_loss(weights_list, sdist_list, per_ray=True)
            outputs["distortion_per_ray"] = L.lossfun_distortion(sdist_list[-1], w_nosky[..., 0])

            # carving: per-ray sum of the squared weights of lidar samples away from the return, without the sky
            # sample (it would penalise weight at the sky on non-returning rays, against the non-return term)
            is_lidar = self._is_lidar_mask(ray_bundle, num_cam_rays)
            ranges = ray_bundle.metadata.get("directions_norm")
            did_return = ray_bundle.metadata.get("did_return")
            if ranges is not None:
                mask = self._carving_mask(ray_samples, is_lidar, ranges, did_return)[..., :-1]
                outputs["carving_per_ray"] = torch.sum((w_nosky[..., 0] * mask) ** 2, dim=-1)
                for i, ps in enumerate(prop_samples):
                    pmask = self._carving_mask(ps, is_lidar, ranges, did_return)
                    outputs[f"prop_carving_per_ray_{i}"] = torch.sum((prop_weights[i][..., 0] * pmask) ** 2, dim=-1)
        return outputs

    def query_geometry(self, points: torch.Tensor, time: float = 0.0) -> torch.Tensor:
        """Field geometry at world points [N, 3]: SDF (use_sdf) or density [N].
        Points become degenerate frustums (tiny extent and pixel area), so the
        field's own code path runs without rays."""
        n = points.shape[0]
        eps = 1e-3
        full = lambda value: torch.full((n, 1, 1), value, dtype=points.dtype, device=points.device)
        frustums = Frustums(
            origins=points[:, None, :],
            directions=torch.tensor([1.0, 0.0, 0.0], dtype=points.dtype, device=points.device).expand(n, 1, 3),
            starts=full(0.0),
            ends=full(eps),
            pixel_area=full(eps),
        )
        samples = RaySamples(frustums=frustums, deltas=full(eps), times=full(time)[:, 0])
        out = self.field(samples)
        geo = out.sdf if out.sdf is not None else out.density
        return geo[..., 0, 0]

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _is_lidar_mask(self, ray_bundle: RayBundle, num_cam_rays: int) -> torch.Tensor:
        """Per-ray lidar flag: metadata `is_lidar` when present (chunk-safe),
        else the static [cam..., lidar...] layout split."""
        if "is_lidar" in ray_bundle.metadata:
            return ray_bundle.metadata["is_lidar"][..., 0]
        n = ray_bundle.origins.shape[0]
        return torch.arange(n, device=ray_bundle.origins.device) >= num_cam_rays

    def _scale_pixel_area(self, ray_bundle: RayBundle, num_cam_rays: int) -> RayBundle:
        """A camera ray covers upsample^2 pixels."""
        is_cam = ~self._is_lidar_mask(ray_bundle, num_cam_rays)[:, None]
        scaling = torch.where(is_cam, float(self.rgb_upsample_factor**2), 1.0)
        return ray_bundle.replace(pixel_area=ray_bundle.pixel_area * scaling)

    def _get_ray_samples(self, ray_bundle: RayBundle, jitters: Optional[Sequence[torch.Tensor]], edits=None):
        """Proposal sampling, then the last sample is stretched to the sky."""
        sky = self.sampling.sky_distance
        fars = ray_bundle.fars if ray_bundle.fars is not None else torch.full_like(ray_bundle.pixel_area, sky)
        fars = fars.clamp_max(sky)
        nears = ray_bundle.nears if ray_bundle.nears is not None else torch.zeros_like(fars)
        ray_bundle = ray_bundle.replace(nears=nears, fars=fars)

        spacing = power_spacing(self.sampling.power_lambda, self.sampling.power_scaling)
        fields = [self.proposal_fields[min(i, len(self.proposal_fields) - 1)] for i in range(self.num_proposal_rounds)]
        density_fns = [lambda samples, f=f: f.get_density(samples, edits=edits) for f in fields]
        ray_samples, weights_list, samples_list = proposal_sampler(
            ray_bundle, density_fns, self.sampling.num_proposal_samples, self.sampling.num_nerf_samples,
            spacing=spacing, jitters=jitters,
        )
        f = ray_samples.frustums
        dist_to_sky = sky - f.ends[..., -1:, :]
        new_ends = torch.cat([f.ends[..., :-1, :], f.ends[..., -1:, :] + dist_to_sky], dim=-2)
        new_deltas = torch.cat([ray_samples.deltas[..., :-1, :], ray_samples.deltas[..., -1:, :] + dist_to_sky], dim=-2)
        new_spacing_ends = torch.cat(
            [ray_samples.spacing_ends[..., :-1, :], torch.full_like(ray_samples.spacing_ends[..., -1:, :], 1.0 - EPS)],
            dim=-2,
        )
        ray_samples = ray_samples.replace(
            frustums=f.replace(ends=new_ends), deltas=new_deltas, spacing_ends=new_spacing_ends
        )
        return ray_samples, weights_list, samples_list

    def _carving_mask(
        self, ray_samples: RaySamples, is_lidar: torch.Tensor, ranges: torch.Tensor, did_return: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """[R, S] mask of lidar samples not close to the measured return; the
        weights there should carve to zero."""
        sample_dist = (ray_samples.frustums.starts + ray_samples.frustums.ends)[..., 0] * 0.5  # [R, S]
        close_to_hit = torch.abs(ranges - sample_dist) < self.loss.carving_epsilon
        if did_return is not None:
            in_range = sample_dist < self.loss.non_return_lidar_distance
            is_close = torch.where(did_return, close_to_hit, in_range)
        else:
            is_close = close_to_hit
        return (~is_close) & is_lidar[:, None]

    def _get_appearance_embedding(self, ray_bundle: RayBundle, features: torch.Tensor) -> torch.Tensor:
        """Per-sensor appearance, interpolated in time between the sensor's embeddings."""
        sensor_idx = ray_bundle.metadata.get("sensor_idxs")
        if sensor_idx is None:
            sensor_idx = torch.zeros((features.shape[0], 1), dtype=torch.long, device=features.device)
        sensor_idx = sensor_idx[..., 0].long()

        if self.use_temporal_appearance:
            eps_per_sensor = self._num_embeds_per_sensor
            if ray_bundle.times is not None:
                times = ray_bundle.times[..., 0]
            else:
                times = torch.zeros(features.shape[0], dtype=features.dtype, device=features.device)
            time_idx = times / self.duration * eps_per_sensor
            before = torch.floor(time_idx).clamp(0, eps_per_sensor - 1)
            after = (before + 1).clamp(0, eps_per_sensor - 1)
            ratio = (time_idx - before)[..., None]
            before_embed = self.appearance_embedding((before + sensor_idx * eps_per_sensor).long())
            after_embed = self.appearance_embedding((after + sensor_idx * eps_per_sensor).long())
            return before_embed * (1.0 - ratio) + after_embed * ratio
        return self.appearance_embedding(sensor_idx)

    # ------------------------------------------------------------------
    # losses & metrics
    # ------------------------------------------------------------------

    def compute_losses(
        self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], num_cam_rays: int,
        vgg: Optional[Vgg19Slices] = None, terms: Optional[L.BatchTerms] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss -> (total, metrics: unweighted metrics and the
        weighted losses, detached). batch: `image` [B, Hp, Wp, 3] patches; the
        lidar rays' `distance`, `did_return`, `intensity` [N_l, 1]. `vgg`: the
        perceptual network (the VGG term needs it and `vgg_mult` > 0).
        `terms`: how each term reduces over the batch (`L.BatchTerms`: this
        batch; `sharding.GlobalBatchTerms`: a data-parallel world's global
        batch, of which `outputs` and `batch` are this rank's rows)."""
        conf = self.loss
        terms = terms or L.BatchTerms()
        loss_dict: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}

        if "image" in batch and "rgb" in outputs:
            image, rgb = batch["image"], outputs["rgb"]
            loss_dict["rgb_loss"] = terms.mean((image - rgb) ** 2) * conf.rgb_mult
            metrics["psnr"] = terms.psnr(rgb.detach(), image)
            if conf.vgg_mult > 0.0 and vgg is not None:
                loss_dict["vgg_loss"] = terms.of_mean(vgg_perceptual_loss(vgg, rgb, image)) * conf.vgg_mult

        if "distance" in batch:
            depth = outputs["depth"][num_cam_rays:]  # [N_l, 1]
            n_lidar = float(depth.shape[0])
            did_return = batch["did_return"][..., 0]  # [N_l]
            termination = batch["distance"]  # [N_l, 1]

            def depth_terms(pred_depth):
                nonret = torch.clamp_min(pred_depth.detach(), conf.non_return_lidar_distance)
                target = torch.where(did_return[:, None], termination, nonret)
                unred = torch.abs(target - pred_depth)
                return torch.where(did_return[:, None], unred, unred * conf.non_return_loss_mult)

            unred = depth_terms(depth)
            quantile = terms.masked_quantile(unred, torch.ones_like(unred, dtype=torch.bool), conf.quantile_threshold)
            qmask = (unred < quantile)[..., 0]
            metrics["depth_loss"] = terms.masked_mean(unred[..., 0], qmask)
            loss_dict["depth_loss"] = conf.depth_mult * metrics["depth_loss"]

            if "intensity" in outputs:
                qr = qmask & did_return
                int_err = (batch["intensity"] - outputs["intensity"]) ** 2
                metrics["intensity_loss"] = terms.masked_mean(int_err[..., 0], qr)
                loss_dict["intensity_loss"] = conf.intensity_mult * metrics["intensity_loss"]

                logits = outputs["ray_drop_logits"][..., 0]
                targets = (~did_return).to(logits.dtype)
                bce = torch.clamp_min(logits, 0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
                metrics["ray_drop_loss"] = terms.mean(bce)
                loss_dict["ray_drop_loss"] = conf.ray_drop_loss_mult * metrics["ray_drop_loss"]
                metrics["ray_drop_accuracy"] = terms.mean(
                    ((torch.sigmoid(logits) > 0.5) == ~did_return).to(torch.float32))

            metrics["depth_median_l2"] = terms.masked_quantile((depth - termination) ** 2, did_return[:, None], 0.5)
            rel = ((depth - termination) / termination.clamp_min(EPS)) ** 2
            metrics["depth_mean_rel_l2"] = terms.masked_mean(rel[..., 0], did_return)

            if "carving_per_ray" in outputs:
                metrics["carving_loss"] = terms.ratio(torch.sum(outputs["carving_per_ray"]), n_lidar)
                loss_dict["carving_loss"] = conf.carving_mult * metrics["carving_loss"]
                for i in range(self.num_proposal_rounds):
                    metrics[f"carving_loss_{i}"] = terms.ratio(torch.sum(outputs[f"prop_carving_per_ray_{i}"]), n_lidar)
                    loss_dict[f"carving_loss_{i}"] = (
                        conf.prop_lidar_loss_mult * conf.carving_mult * metrics[f"carving_loss_{i}"])
                    pd = outputs[f"prop_depth_{i}"][num_cam_rays:]
                    metrics[f"depth_loss_{i}"] = terms.mean(depth_terms(pd))
                    loss_dict[f"depth_loss_{i}"] = conf.prop_lidar_loss_mult * conf.depth_mult * metrics[
                        f"depth_loss_{i}"]

        if "interlevel_per_ray" in outputs:
            loss_dict["interlevel_loss"] = conf.interlevel_loss_mult * terms.mean(outputs["interlevel_per_ray"])
            metrics["distortion"] = terms.mean(outputs["distortion_per_ray"])
            loss_dict["distortion_loss"] = conf.distortion_loss_mult * metrics["distortion"]

        if self.camera_opt_mode != "off":
            loss_dict["camera_opt_regularizer"] = self.camera_optimizer.regularization_loss()

        total = sum(loss_dict.values(), torch.zeros((), device=outputs["depth"].device))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update({k: v.detach() for k, v in loss_dict.items()})
        return total, metrics
