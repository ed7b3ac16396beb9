"""Occupancy-grid ray marching, instant-ngp's volumetric sampling (torch port
of `neurad_tpu/model_components/occupancy_grid.py`; nerfacc's
`OccGridEstimator` and nerfstudio's `VolumetricSampler`).

The grid is a dense, exponentially averaged density field over the scene box,
and sampling keeps a fixed number of samples a ray: "march" probes uniform
steps and keeps the first occupied bins in depth order (padded with the
nearest empty ones), "resample" draws bins by inverse CDF with occupied bins
weighted 1 and empty ones 1e-3. Random draws are explicit tensors, as in
`ray_samplers.py`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from neurad_tpu_torch.core.structs import RayBundle, RaySamples
from neurad_tpu_torch.model_components.ray_samplers import UNIFORM, pdf_sampler, spaced_sampler


class OccupancyGridState(NamedTuple):
    """The averaged density grid over the scene box."""

    densities: torch.Tensor  # [R, R, R]
    aabb: torch.Tensor  # [2, 3]

    @property
    def resolution(self) -> int:
        return self.densities.shape[0]


def init_occupancy_grid(aabb: torch.Tensor, resolution: int = 128) -> OccupancyGridState:
    return OccupancyGridState(densities=torch.zeros((resolution,) * 3, device=aabb.device), aabb=aabb)


def update_occupancy_grid(state: OccupancyGridState, density_fn: Callable[[torch.Tensor], torch.Tensor],
                          jitter: Optional[torch.Tensor] = None, ema_decay: float = 0.95,
                          generator: Optional[torch.Generator] = None) -> OccupancyGridState:
    """The decayed grid's maximum with the density at one jittered point a
    cell (`jitter`: uniform draws [R^3, 3] in the cells' x, y, z order, drawn
    from `generator` when not given)."""
    r = state.resolution
    dev = state.densities.device
    axis = torch.arange(r, device=dev)
    idx = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1).reshape(-1, 3)
    if jitter is None:
        jitter = torch.rand(idx.shape, generator=generator, device=dev)
    unit = (idx + jitter) / r
    pos = state.aabb[0] + unit * (state.aabb[1] - state.aabb[0])
    dens = density_fn(pos).reshape((r,) * 3)
    return state._replace(densities=torch.maximum(state.densities * ema_decay, dens))


def occupancy_at(state: OccupancyGridState, positions: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """Occupancy (density above `threshold`, inside the box) at world positions [..., 3]."""
    unit = (positions - state.aabb[0]) / (state.aabb[1] - state.aabb[0])
    r = state.resolution
    idx = (unit * r).to(torch.int32).clamp(0, r - 1).long()
    dens = state.densities[idx[..., 0], idx[..., 1], idx[..., 2]]
    inside = torch.all((unit >= 0) & (unit < 1), dim=-1)
    return (dens > threshold) & inside


def volumetric_sampler(
    bundle: RayBundle,
    grid: OccupancyGridState,
    num_samples: int = 256,
    jitter: Optional[torch.Tensor] = None,
    threshold: float = 0.01,
    mode: str = "march",
    march_candidates: int = 1024,
) -> Tuple[RaySamples, torch.Tensor]:
    """A fixed number of occupancy-aware samples a ray -> (samples, their
    occupancy [R, S]). "march": of `march_candidates` uniform steps, the
    first `num_samples` occupied ones in depth order (then the nearest empty
    ones). "resample": inverse-CDF resampling onto occupied bins, `jitter`
    its uniform draws [R, num_samples + 1] (None: bin centres)."""
    if mode == "march":
        probe = spaced_sampler(bundle, march_candidates, UNIFORM)
        occ = occupancy_at(grid, probe.frustums.get_positions(), threshold)  # [R, M]
        m = march_candidates
        order = torch.arange(m, dtype=torch.float32, device=occ.device)
        # occupied bins rank before empty ones; within each class, the nearest first (no ties)
        score = torch.where(occ, 2.0 * m - order, m - order)
        pick = torch.sort(torch.topk(score, num_samples, dim=-1).indices, dim=-1).values  # back in depth order

        def take(arr):
            return None if arr is None else torch.gather(arr, -2, pick[..., None])

        samples = bundle.get_ray_samples(bin_starts=take(probe.frustums.starts), bin_ends=take(probe.frustums.ends),
                                         spacing_starts=take(probe.spacing_starts),
                                         spacing_ends=take(probe.spacing_ends))
        return samples, torch.gather(occ, -1, pick)
    probe = spaced_sampler(bundle, num_samples, UNIFORM)
    occ = occupancy_at(grid, probe.frustums.get_positions(), threshold)  # [R, S]
    w = torch.where(occ, 1.0, 1e-3)[..., None]
    samples = pdf_sampler(bundle, probe, w, num_samples, UNIFORM, jitter=jitter)
    return samples, occupancy_at(grid, samples.frustums.get_positions(), threshold)
