"""Proposal density fields of the nerfacto models (torch port of
`neurad_tpu/fields/density_fields.py`): a small hash grid and an MLP (or one
linear layer) -> trunc_exp density."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from neurad_tpu_torch.core.scene_box import SceneBox
from neurad_tpu_torch.core.structs import RaySamples
from neurad_tpu_torch.fields.activations import trunc_exp
from neurad_tpu_torch.fields.encodings import HashEncoding
from neurad_tpu_torch.fields.mlp import MLP
from neurad_tpu_torch.fields.spatial_distortions import scene_contraction


def field_positions(ray_samples: RaySamples, aabb: torch.Tensor, use_scene_contraction: bool) -> torch.Tensor:
    """The samples' midpoints in the hash grid's [0, 1]^3: contracted and
    mapped by (x + 2) / 4, or normalised by the scene box."""
    positions = ray_samples.frustums.get_positions()
    if use_scene_contraction:
        return (scene_contraction(positions) + 2.0) / 4.0
    return SceneBox.get_normalized_positions(positions, aabb)


class HashMLPDensityField(nn.Module):
    """Density-only proposal field. `aabb`: ((min xyz), (max xyz))."""

    def __init__(
        self,
        aabb: Sequence[Sequence[float]],
        num_layers: int = 2,
        hidden_dim: int = 16,
        num_levels: int = 5,
        base_res: int = 16,
        max_res: int = 256,
        log2_hashmap_size: int = 18,
        features_per_level: int = 2,
        use_scene_contraction: bool = True,
        use_linear: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.register_buffer("aabb", torch.tensor(aabb, dtype=torch.float32), persistent=False)
        self.use_scene_contraction = use_scene_contraction
        self.encoding = HashEncoding(num_levels=num_levels, min_res=base_res, max_res=max_res,
                                     log2_hashmap_size=log2_hashmap_size, features_per_level=features_per_level,
                                     generator=generator)
        if use_linear:
            self.head = nn.Linear(self.encoding.out_dim, 1)
        else:
            self.head = MLP(self.encoding.out_dim, 1, num_layers=num_layers, layer_width=hidden_dim)

    def get_density(self, ray_samples: RaySamples) -> torch.Tensor:
        feats = self.encoding(field_positions(ray_samples, self.aabb, self.use_scene_contraction))
        return trunc_exp(self.head(feats))

    def forward(self, ray_samples: RaySamples) -> torch.Tensor:
        return self.get_density(ray_samples)
