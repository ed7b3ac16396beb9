"""Ray and sample containers (torch port of `neurad_tpu/core/structs.py`):
plain dataclasses of tensors. `replace` swaps fields like the JAX pytrees'
`.replace`; `map_tensors` applies a function to every tensor of a container
(its metadata dict included), which is what indexing, padding and
concatenating a bundle along the ray axis need.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj):
    """A copy of a container with `fn` applied to every tensor field, nested
    containers and the metadata dict included; None stays None."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj, **{f.name: map_tensors(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    return obj


@dataclasses.dataclass
class GaussiansStd:
    """Isotropic gaussian (mean + scalar std) used for hashgrid anti-aliasing."""

    mean: torch.Tensor  # [*batch, num_multisamples, 3]
    std: torch.Tensor  # [*batch, num_multisamples, 1]


@dataclasses.dataclass
class Frustums:
    """Conical frustums along rays."""

    origins: torch.Tensor  # [*batch, 3]
    directions: torch.Tensor  # [*batch, 3] (unit)
    starts: torch.Tensor  # [*batch, 1]
    ends: torch.Tensor  # [*batch, 1]
    pixel_area: torch.Tensor  # [*batch, 1] (at distance 1 from the origin)

    def replace(self, **changes) -> "Frustums":
        return dataclasses.replace(self, **changes)

    def get_positions(self) -> torch.Tensor:
        """Midpoint of each frustum [*batch, 3]."""
        return self.origins + self.directions * (self.starts + self.ends) / 2.0

    def get_start_positions(self) -> torch.Tensor:
        """Start point of each frustum [*batch, 3]."""
        return self.origins + self.directions * self.starts

    def get_fast_isotropic_gaussian(self, num_multisamples: int) -> GaussiansStd:
        """Isotropic gaussian approximation of the frustum: `num_multisamples`
        points evenly inside (starts, ends); std is the cube root of
        (cross-section area * multisample spacing)."""
        multisample_dist = (self.ends - self.starts) / (num_multisamples + 1)  # [*b, 1]
        ts = torch.arange(1, num_multisamples + 1, dtype=self.ends.dtype, device=self.ends.device)  # [m]
        t = self.starts + ts * multisample_dist  # [*b, m]
        mean = self.origins[..., None, :] + self.directions[..., None, :] * t[..., :, None]  # [*b, m, 3]
        frust_crossection_area = self.pixel_area[..., None, :] * (t[..., :, None] ** 2)
        std = (frust_crossection_area * multisample_dist[..., None, :]) ** (1.0 / 3.0)
        return GaussiansStd(mean=mean, std=std)


@dataclasses.dataclass
class RaySamples:
    """Samples along rays. Spacing bins are stored as tensors; the spacing
    transform lives with the sampler that created the samples."""

    frustums: Frustums
    deltas: torch.Tensor  # [*batch, num_samples, 1]
    spacing_starts: Optional[torch.Tensor] = None  # [*batch, num_samples, 1] in [0, 1]
    spacing_ends: Optional[torch.Tensor] = None
    camera_indices: Optional[torch.Tensor] = None  # [*batch, 1] int
    times: Optional[torch.Tensor] = None  # [*batch, 1]
    metadata: dict = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> "RaySamples":
        return dataclasses.replace(self, **changes)

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """Volume-rendering weights from densities:
        w_i = (1 - exp(-delta_i * sigma_i)) * exp(-sum_{j<i} delta_j * sigma_j)."""
        delta_density = self.deltas * densities
        alphas = 1.0 - torch.exp(-delta_density)
        trans = torch.cumsum(delta_density[..., :-1, :], dim=-2)
        trans = torch.cat([torch.zeros_like(trans[..., :1, :]), trans], dim=-2)
        trans = torch.exp(-trans)
        return torch.nan_to_num(alphas * trans)

    @staticmethod
    def get_weights_and_transmittance_from_alphas(alphas: torch.Tensor):
        """Weights from per-sample alphas: exclusive cumprod of (1 - alpha)."""
        trans = torch.cumprod(
            torch.cat([torch.ones_like(alphas[..., :1, :]), 1.0 - alphas + 1e-7], dim=-2), dim=-2
        )
        return alphas * trans[..., :-1, :], trans


@dataclasses.dataclass
class RayBundle:
    """A bundle of rays. `metadata` keys used by AD models: `is_lidar` [*b, 1]
    bool, `did_return` [*b, 1] bool, `directions_norm` [*b, 1] (lidar ranges),
    `sensor_idxs` [*b, 1] int."""

    origins: torch.Tensor  # [*batch, 3]
    directions: torch.Tensor  # [*batch, 3]
    pixel_area: torch.Tensor  # [*batch, 1]
    camera_indices: Optional[torch.Tensor] = None  # [*batch, 1] int
    nears: Optional[torch.Tensor] = None  # [*batch, 1]
    fars: Optional[torch.Tensor] = None  # [*batch, 1]
    times: Optional[torch.Tensor] = None  # [*batch, 1]
    metadata: dict = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)

    @property
    def shape(self):
        return self.origins.shape[:-1]

    def __len__(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def reshape(self, shape: tuple) -> "RayBundle":
        """The bundle with batch shape `shape`: every tensor keeps its last
        (feature) dimension."""
        return map_tensors(lambda x: x.reshape(tuple(shape) + x.shape[-1:]), self)

    def flatten(self) -> "RayBundle":
        """The bundle with one batch dimension."""
        return self.reshape((-1,))

    def get_ray_samples(
        self,
        bin_starts: torch.Tensor,
        bin_ends: torch.Tensor,
        spacing_starts: Optional[torch.Tensor] = None,
        spacing_ends: Optional[torch.Tensor] = None,
    ) -> RaySamples:
        """RaySamples between bin edges [*batch, num_samples, 1]; per-ray fields
        are broadcast along the sample axis (views, not copies)."""
        num_samples = bin_starts.shape[-2]
        broadcast = lambda x: None if x is None else x[..., None, :].expand(x.shape[:-1] + (num_samples, x.shape[-1]))
        return RaySamples(
            frustums=Frustums(
                origins=broadcast(self.origins),
                directions=broadcast(self.directions),
                starts=bin_starts,
                ends=bin_ends,
                pixel_area=broadcast(self.pixel_area),
            ),
            deltas=bin_ends - bin_starts,
            spacing_starts=spacing_starts,
            spacing_ends=spacing_ends,
            camera_indices=broadcast(self.camera_indices),
            times=broadcast(self.times),
            metadata=dict(self.metadata),
        )
