"""NeuRAD neural feature fields (torch port of
`neurad_tpu/fields/neurad_field.py`): the main field (hashgrid -> geometry MLP
-> SDF or density + feature MLP on SH-encoded directions) and the two proposal
density fields (fourier features + MLP, or a one-feature hashgrid)."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from neurad_tpu_torch.core.structs import RaySamples
from neurad_tpu_torch.fields.activations import trunc_exp
from neurad_tpu_torch.fields.mlp import MLP
from neurad_tpu_torch.fields.neurad_encoding import ActorSettings, NeuRADHashEncoding, StaticSettings
from neurad_tpu_torch.fields.spatial_distortions import scaled_scene_contraction_gaussian
from neurad_tpu_torch.model_components.dynamic_actors import DynamicActors
from neurad_tpu_torch.ops.spherical_harmonics import components_from_spherical_harmonics


class SigmoidDensity(nn.Module):
    """SDF -> alpha via a learnable-slope sigmoid."""

    def __init__(self, init_beta: float = 20.0, beta_min: float = 1e-4, learnable_beta: bool = True):
        super().__init__()
        self.init_beta = init_beta
        self.beta_min = beta_min
        self.learnable_beta = learnable_beta
        if learnable_beta:
            self.beta = nn.Parameter(torch.tensor([init_beta], dtype=torch.float32))

    def forward(self, sdf: torch.Tensor) -> torch.Tensor:
        beta = self.beta.abs() + self.beta_min if self.learnable_beta else self.init_beta
        return torch.sigmoid(-sdf * beta)


class FieldOutputs(NamedTuple):
    """Field head outputs."""

    features: torch.Tensor  # [R, S, nff_out_dim]
    alphas: Optional[torch.Tensor] = None  # [R, S, 1] (use_sdf path)
    sdf: Optional[torch.Tensor] = None  # [R, S, 1]
    density: Optional[torch.Tensor] = None  # [R, S, 1] (trunc_exp path)


def get_normalized_directions(directions: torch.Tensor) -> torch.Tensor:
    """SH-encoding input normalisation: [-1, 1] -> [0, 1]."""
    return (directions + 1.0) / 2.0


def _sample_times(ray_samples: RaySamples) -> torch.Tensor:
    if ray_samples.times is not None:
        return ray_samples.times
    return torch.zeros_like(ray_samples.deltas[..., 0, :])


class NeuRADField(nn.Module):
    """The main neural feature field: hashgrid -> mlp_geo (2 layers, 32 wide) ->
    (sdf | density, geo embedding 32); SH(4)-encoded actor-frame directions ->
    mlp_feature (3 x 32) + residual. `compute_dtype` is the MLPs' (None = fp32)."""

    def __init__(
        self,
        actors: DynamicActors,
        static_scale: float,
        static: StaticSettings = StaticSettings(),
        actor: ActorSettings = ActorSettings(flip_prob=0.25),
        geo_hidden_dim: int = 32,
        geo_num_layers: int = 2,
        nff_hidden_dim: int = 32,
        nff_num_layers: int = 3,
        nff_out_dim: int = 32,
        num_multisamples: int = 1,
        use_sdf: bool = True,
        sdf_beta: float = 20.0,
        learnable_beta: bool = True,
        require_actor_grad: bool = True,
        max_actors_per_ray: int = 4,
        sh_levels: int = 4,
        actor_compaction: int = 8,
        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_multisamples = num_multisamples
        self.use_sdf = use_sdf
        self.sh_levels = sh_levels
        self.hashgrid = NeuRADHashEncoding(
            actors=actors, static_scale=static_scale, static=static, actor=actor,
            require_actor_grad=require_actor_grad, max_actors_per_ray=max_actors_per_ray,
            actor_compaction=actor_compaction, generator=generator,
        )
        self.mlp_geo = MLP(self.hashgrid.out_dim, nff_out_dim + 1, num_layers=geo_num_layers,
                           layer_width=geo_hidden_dim, compute_dtype=compute_dtype)
        self.mlp_feature = MLP(nff_out_dim + sh_levels**2, nff_out_dim, num_layers=nff_num_layers,
                               layer_width=nff_hidden_dim, compute_dtype=compute_dtype)
        if use_sdf:
            self.sdf_to_alpha = SigmoidDensity(init_beta=sdf_beta, learnable_beta=learnable_beta)

    def forward(self, ray_samples: RaySamples, flip_draw: Optional[torch.Tensor] = None, edits=None) -> FieldOutputs:
        gaussians = ray_samples.frustums.get_fast_isotropic_gaussian(self.num_multisamples)
        features, directions = self.hashgrid(
            gaussians, _sample_times(ray_samples), ray_samples.frustums.directions, flip_draw=flip_draw, edits=edits
        )
        batch_shape = features.shape[:-1]
        geo = self.mlp_geo(features.reshape(-1, features.shape[-1]))  # [N, 1 + nff_out_dim]
        geo_out, geo_embedding = geo[..., :1], geo[..., 1:]
        dir_embedding = components_from_spherical_harmonics(
            self.sh_levels, get_normalized_directions(directions)
        ).reshape(geo.shape[0], -1)
        feature = geo_embedding + self.mlp_feature(torch.cat([geo_embedding, dir_embedding], dim=-1))
        feature = feature.reshape(batch_shape + (feature.shape[-1],))
        geo_out = geo_out.reshape(batch_shape + (1,))
        if self.use_sdf:
            return FieldOutputs(features=feature, sdf=geo_out, alphas=self.sdf_to_alpha(geo_out))
        return FieldOutputs(features=feature, density=trunc_exp(geo_out))


class MLPProposalField(nn.Module):
    """Matmul-only proposal density: positions are scene-contracted,
    fourier-encoded (plus low-frequency time features, so that dynamic actors
    register as time-varying density) and decoded by a small bf16 MLP with an
    fp32 bias-free density head and `trunc_exp`. The head starts near zero, so
    the initial proposal is uniform."""

    def __init__(self, static_scale: float, num_freqs: int = 10, num_time_freqs: int = 4, time_scale: float = 0.25,
                 hidden_dim: int = 128, num_layers: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.static_scale = static_scale
        self.num_freqs = num_freqs
        self.num_time_freqs = num_time_freqs
        self.time_scale = time_scale
        in_dim = 3 + 2 * 3 * num_freqs + 2 * num_time_freqs
        self.mlp = MLP(in_dim, hidden_dim, num_layers=num_layers, layer_width=hidden_dim)
        self.density_decoder = nn.Linear(hidden_dim, 1, bias=False)
        with torch.no_grad():
            dev = generator.device if generator is not None else None
            self.density_decoder.weight.copy_(torch.randn(1, hidden_dim, generator=generator, device=dev) * 1e-4)

    def get_density(self, ray_samples: RaySamples, edits=None) -> torch.Tensor:
        gaussians = ray_samples.frustums.get_fast_isotropic_gaussian(1)
        g = scaled_scene_contraction_gaussian(gaussians, self.static_scale)
        x = g.mean.squeeze(-2)  # [R, S, 3] in [0, 1]
        times = _sample_times(ray_samples)
        t = times.reshape(times.shape[0], -1, 1)[:, :1, :].expand(x.shape[:-1] + (1,))

        octaves = 2.0 ** torch.arange(self.num_freqs, dtype=x.dtype, device=x.device) * math.pi
        ang = x[..., None] * octaves  # [R, S, 3, F]
        t_oct = 2.0 ** torch.arange(self.num_time_freqs, dtype=x.dtype, device=x.device) * self.time_scale
        t_ang = t[..., None] * t_oct  # [R, S, 1, Ft]
        flat = lambda v: v.reshape(x.shape[:-1] + (-1,))
        feats = torch.cat([x, flat(torch.sin(ang)), flat(torch.cos(ang)), flat(torch.sin(t_ang)),
                           flat(torch.cos(t_ang))], dim=-1)
        return trunc_exp(self.density_decoder(self.mlp(feats)))

    def forward(self, ray_samples: RaySamples, edits=None) -> torch.Tensor:
        return self.get_density(ray_samples, edits=edits)


class NeuRADProposalField(nn.Module):
    """Density-only proposal field: hashgrid -> bias-free linear -> trunc_exp."""

    def __init__(
        self,
        actors: DynamicActors,
        static_scale: float,
        static: StaticSettings = StaticSettings(
            log2_hashmap_size=20, num_levels=6, max_res=4096, base_res=128, hashgrid_dim=1
        ),
        actor: ActorSettings = ActorSettings(
            log2_hashmap_size=15, num_levels=4, base_res=64, max_res=1024, hashgrid_dim=1
        ),
        max_actors_per_ray: int = 4,
        actor_compaction: int = 8,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hashgrid = NeuRADHashEncoding(
            actors=actors, static_scale=static_scale, static=static, actor=actor,
            require_actor_grad=False,  # no trajectory gradients through proposals
            max_actors_per_ray=max_actors_per_ray, actor_compaction=actor_compaction, generator=generator,
        )
        self.density_decoder = nn.Linear(self.hashgrid.out_dim, 1, bias=False)

    def get_density(self, ray_samples: RaySamples, edits=None) -> torch.Tensor:
        gaussians = ray_samples.frustums.get_fast_isotropic_gaussian(1)
        feats, _ = self.hashgrid(gaussians, _sample_times(ray_samples), None, edits=edits)
        out = trunc_exp(self.density_decoder(feats.reshape(-1, feats.shape[-1])))
        return out.reshape(feats.shape[:-1] + (1,))

    def forward(self, ray_samples: RaySamples, edits=None) -> torch.Tensor:
        return self.get_density(ray_samples, edits=edits)
