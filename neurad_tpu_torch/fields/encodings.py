"""Encodings: hash grid, spherical harmonics, NeRF frequency (torch port of
`neurad_tpu/fields/encodings.py`).

`HashEncoding` keeps one parameter per level (`hash_table.<l>`), shaped
[rows_l, f_row * bucket_pack_l] as `ops/hash_encoding.table_physical_shapes`
gives it; the JAX package stores each level as a 1-D leaf, which the parameter
bridge reshapes. Its lookups go through `ops/hash_encoding`: on CUDA tensors
the hash-grid kernels (forward and backward), on CPU tensors their plain
versions. Reads and interpolation are in bf16 (`gather_dtype`), as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from neurad_tpu_torch.core.structs import GaussiansStd
from neurad_tpu_torch.ops import hash_encoding as he
from neurad_tpu_torch.ops.spherical_harmonics import components_from_spherical_harmonics


class HashEncoding(nn.Module):
    """Multi-resolution hash encoding of positions in [0, 1]^D (D = 3 or 4),
    one row a grid corner (the unpacked layout). Called with a `GaussiansStd` it weights each level by the gaussian's std
    and averages over the multisamples. `generator` draws the tables (on its
    device)."""

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 1024,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        n_input_dims: int = 3,
        hash_init_scale: float = 0.001,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_levels = num_levels
        self.features_per_level = features_per_level
        self.table_size = 2**log2_hashmap_size
        self.scales = he.level_scales(num_levels, min_res, max_res)
        _, self.dense_res, self.bucket_pack = he.level_layout(self.scales, n_input_dims, self.table_size, False)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        tables = he.init_hash_tables(generator, self.scales, n_input_dims, self.table_size, features_per_level,
                                     hash_init_scale, cell_packed=False)
        self.hash_table = nn.ParameterList([nn.Parameter(t) for t in tables])
        self.gather_dtype: Optional[torch.dtype] = torch.bfloat16  # None: fp32 reads

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def _layout(self) -> dict:
        return dict(cell_packed=False, dense_res=self.dense_res, bucket_pack=self.bucket_pack,
                    gather_dtype=self.gather_dtype)

    def forward(self, positions: Union[torch.Tensor, GaussiansStd]) -> torch.Tensor:
        if isinstance(positions, GaussiansStd):
            return he.hash_encode_gaussians(positions.mean, positions.std, self.hash_table, self.scales,
                                            **self._layout())
        return he.hash_encode(positions, self.hash_table, self.scales, **self._layout())

    def encode_with_level_weights(self, positions: torch.Tensor, level_weights: Optional[torch.Tensor]) -> torch.Tensor:
        return he.hash_encode(positions, self.hash_table, self.scales, level_weights=level_weights, **self._layout())


class SHEncoding(nn.Module):
    """Spherical-harmonic encoding of unit directions, `levels` ** 2 values."""

    def __init__(self, levels: int = 4):
        super().__init__()
        self.levels = levels

    @property
    def out_dim(self) -> int:
        return self.levels**2

    def forward(self, directions: torch.Tensor) -> torch.Tensor:
        return components_from_spherical_harmonics(self.levels, directions)


class NeRFEncoding(nn.Module):
    """Sinusoidal frequency encoding: sin and cos of 2 pi x 2^k for
    `num_frequencies` exponents k from `min_freq_exp` to `max_freq_exp`."""

    def __init__(self, in_dim: int = 3, num_frequencies: int = 10, min_freq_exp: float = 0.0,
                 max_freq_exp: float = 8.0, include_input: bool = False):
        super().__init__()
        self.in_dim = in_dim
        self.num_frequencies = num_frequencies
        self.min_freq_exp = min_freq_exp
        self.max_freq_exp = max_freq_exp
        self.include_input = include_input

    @property
    def out_dim(self) -> int:
        return self.in_dim * self.num_frequencies * 2 + (self.in_dim if self.include_input else 0)

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        exps = torch.linspace(self.min_freq_exp, self.max_freq_exp, self.num_frequencies, device=in_tensor.device)
        scaled = (in_tensor[..., None] * 2.0**exps).reshape(in_tensor.shape[:-1] + (-1,))  # [..., D * F]
        encoded = torch.cat([torch.sin(2.0 * math.pi * scaled), torch.cos(2.0 * math.pi * scaled)], dim=-1)
        if self.include_input:
            encoded = torch.cat([encoded, in_tensor], dim=-1)
        return encoded
