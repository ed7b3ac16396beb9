"""The nerfacto field (torch port of `neurad_tpu/fields/nerfacto_field.py`):
hash grid -> density MLP, and a colour head on SH-encoded directions, the
geometry features and a per-image appearance embedding."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from neurad_tpu_torch.core.structs import RaySamples
from neurad_tpu_torch.fields.activations import trunc_exp
from neurad_tpu_torch.fields.density_fields import field_positions
from neurad_tpu_torch.fields.encodings import HashEncoding, SHEncoding
from neurad_tpu_torch.fields.mlp import MLP
from neurad_tpu_torch.fields.neurad_field import get_normalized_directions


class NerfactoOutputs(NamedTuple):
    density: torch.Tensor  # [R, S, 1]
    rgb: torch.Tensor  # [R, S, 3]


class NerfactoField(nn.Module):
    """16 levels of 2 features (base 16, max 2048, 2^19 buckets), SH degree 4,
    a 2-layer base MLP to 1 + 15 outputs, a 3-layer sigmoid colour head and a
    32-wide appearance embedding. Rays without camera indices get the mean
    embedding."""

    def __init__(
        self,
        aabb: Sequence[Sequence[float]],
        num_images: int = 1,
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        appearance_embedding_dim: int = 32,
        num_levels: int = 16,
        base_res: int = 16,
        max_res: int = 2048,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        use_scene_contraction: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.register_buffer("aabb", torch.tensor(aabb, dtype=torch.float32), persistent=False)
        self.use_scene_contraction = use_scene_contraction
        self.appearance_embedding_dim = appearance_embedding_dim
        self.encoding = HashEncoding(num_levels=num_levels, min_res=base_res, max_res=max_res,
                                     log2_hashmap_size=log2_hashmap_size, features_per_level=features_per_level,
                                     generator=generator)
        self.direction_encoding = SHEncoding(levels=4)
        self.mlp_base = MLP(self.encoding.out_dim, 1 + geo_feat_dim, num_layers=num_layers, layer_width=hidden_dim)
        head_in = self.direction_encoding.out_dim + geo_feat_dim + appearance_embedding_dim
        self.mlp_head = MLP(head_in, 3, num_layers=num_layers_color, layer_width=hidden_dim_color,
                            out_activation=torch.sigmoid)
        if appearance_embedding_dim > 0:
            self.appearance_embedding = nn.Embedding(num_images, appearance_embedding_dim)

    def _density_and_embedding(self, ray_samples: RaySamples):
        feats = self.encoding(field_positions(ray_samples, self.aabb, self.use_scene_contraction))
        h = self.mlp_base(feats)
        return trunc_exp(h[..., :1]), h[..., 1:]

    def get_density(self, ray_samples: RaySamples) -> torch.Tensor:
        return self._density_and_embedding(ray_samples)[0]

    def forward(self, ray_samples: RaySamples) -> NerfactoOutputs:
        density, embedding = self._density_and_embedding(ray_samples)
        d_enc = self.direction_encoding(get_normalized_directions(ray_samples.frustums.directions))
        head_in = [d_enc, embedding]
        if self.appearance_embedding_dim > 0:
            if ray_samples.camera_indices is not None:
                embed = self.appearance_embedding(ray_samples.camera_indices[..., 0].long())
            else:
                mean = self.appearance_embedding.weight.mean(dim=0)
                embed = mean.expand(density.shape[:-1] + (self.appearance_embedding_dim,))
            head_in.append(embed)
        return NerfactoOutputs(density=density, rgb=self.mlp_head(torch.cat(head_in, dim=-1)))
