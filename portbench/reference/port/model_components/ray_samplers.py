"""Ray samplers: spaced, PDF (inverse-CDF) and proposal-network hierarchical
sampling (torch port of `neurad_tpu/model_components/ray_samplers.py`).

Samplers are pure functions. Where the JAX package takes a random key, these
take the uniform draws themselves as tensors (`jitter`), so that a test can
hand both packages the same numbers; None is the eval path (bin centres).
The NeuS sampler upsamples by an SDF's s-density, merging each round's
samples into the set sorted by depth (`merge_ray_samples_sorted`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from portbench.reference.port.core.math_utils import inv_power_fn, power_fn
from portbench.reference.port.core.structs import RayBundle, RaySamples


@dataclasses.dataclass(frozen=True)
class Spacing:
    """A monotone spacing transform s(t) and its inverse."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    fn_inv: Callable[[torch.Tensor], torch.Tensor]

    def to_euclidean(self, x: torch.Tensor, nears: torch.Tensor, fars: torch.Tensor) -> torch.Tensor:
        """inv(x * s_far + (1 - x) * s_near)."""
        s_near, s_far = self.fn(nears), self.fn(fars)
        return self.fn_inv(x * s_far + (1.0 - x) * s_near)


UNIFORM = Spacing(lambda x: x, lambda x: x)
LIN_DISP = Spacing(lambda x: 1.0 / x.clamp_min(1e-10), lambda x: 1.0 / x.clamp_min(1e-10))
SQRT = Spacing(torch.sqrt, lambda x: x**2)
LOG = Spacing(torch.log, torch.exp)
# uniform in [0, 1], linear in disparity beyond
UNIFORM_LIN_DISP_PIECEWISE = Spacing(
    lambda x: torch.where(x < 1, x / 2.0, 1.0 - 1.0 / (2.0 * x.clamp_min(1e-10))),
    lambda x: torch.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x).clamp_min(1e-10)),
)


def power_spacing(lambda_: float = -1.5, scaling: float = 2.0) -> Spacing:
    """ZipNeRF's power spacing. NeuRAD uses lambda = -1, scaling = 0.1."""
    return Spacing(
        fn=lambda x: power_fn(x * scaling, lambda_),
        fn_inv=lambda x: inv_power_fn(x, lambda_) / scaling,
    )


def spaced_sampler(
    bundle: RayBundle, num_samples: int, spacing: Spacing = UNIFORM, jitter: Optional[torch.Tensor] = None
) -> RaySamples:
    """Sample bins according to a spacing function. `jitter`: uniform draws
    [R, 1] (one per ray) or [R, num_samples + 1] for stratified sampling; None
    places the bin edges evenly."""
    num_rays = bundle.origins.shape[0]
    dev = bundle.origins.device
    bins = torch.linspace(0.0, 1.0, num_samples + 1, device=dev)[None, :]  # [1, S+1]

    if jitter is not None:
        bin_centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        bin_upper = torch.cat([bin_centers, bins[..., -1:]], -1)
        bin_lower = torch.cat([bins[..., :1], bin_centers], -1)
        bins = bin_lower + (bin_upper - bin_lower) * jitter
    else:
        bins = bins.expand(num_rays, num_samples + 1)

    euclidean_bins = spacing.to_euclidean(bins, bundle.nears, bundle.fars)  # [R, S+1]
    return bundle.get_ray_samples(
        bin_starts=euclidean_bins[..., :-1, None],
        bin_ends=euclidean_bins[..., 1:, None],
        spacing_starts=bins[..., :-1, None],
        spacing_ends=bins[..., 1:, None],
    )


def pdf_sampler(
    bundle: RayBundle,
    ray_samples: RaySamples,
    weights: torch.Tensor,
    num_samples: int,
    spacing: Spacing,
    jitter: Optional[torch.Tensor] = None,
    include_original: bool = False,
    histogram_padding: float = 0.01,
    eps: float = 1e-5,
) -> RaySamples:
    """Inverse-CDF resampling of `ray_samples` by `weights` [R, S, 1].
    `jitter`: uniform draws [R, 1] or [R, num_samples + 1]; None samples the
    middle of each CDF step."""
    num_bins = num_samples + 1
    w = weights[..., 0] + histogram_padding  # [R, S]

    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.relu(eps - w_sum)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding

    pdf = w / w_sum
    cdf = torch.minimum(torch.ones_like(pdf), torch.cumsum(pdf, dim=-1))
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, S+1]

    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, device=cdf.device)
    u = u.expand(cdf.shape[:-1] + (num_bins,))
    if jitter is not None:
        u = u + jitter / num_bins
    else:
        u = u + 1.0 / (2 * num_bins)

    existing_bins = torch.cat(
        [ray_samples.spacing_starts[..., 0], ray_samples.spacing_ends[..., -1:, 0]], dim=-1
    )  # [R, S+1]

    inds = torch.searchsorted(cdf, u.contiguous(), right=True)  # number of cdf entries <= u
    below = (inds - 1).clamp(0, existing_bins.shape[-1] - 1)
    above = inds.clamp(0, existing_bins.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    bins_g0 = torch.gather(existing_bins, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g1 = torch.gather(existing_bins, -1, above)

    t = torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0)).clamp(0.0, 1.0)
    bins = bins_g0 + t * (bins_g1 - bins_g0)

    if include_original:
        bins = torch.sort(torch.cat([existing_bins, bins], dim=-1), dim=-1).values

    bins = bins.detach()
    euclidean_bins = spacing.to_euclidean(bins, bundle.nears, bundle.fars)

    return bundle.get_ray_samples(
        bin_starts=euclidean_bins[..., :-1, None],
        bin_ends=euclidean_bins[..., 1:, None],
        spacing_starts=bins[..., :-1, None],
        spacing_ends=bins[..., 1:, None],
    )


def merge_ray_samples_sorted(a: RaySamples, b: RaySamples) -> RaySamples:
    """Two sample sets of the same rays merged along the sample axis and
    sorted by frustum start; the deltas are recomputed from the sorted bins
    (per-ray fields such as the metadata are `a`'s)."""
    order = torch.argsort(torch.cat([a.frustums.starts, b.frustums.starts], dim=-2)[..., 0], dim=-1)

    def merged(x, y):
        if x is None:
            return None
        xy = torch.cat([x, y], dim=-2)
        return torch.gather(xy, -2, order[..., None].expand(order.shape + xy.shape[-1:]))

    f = dataclasses.replace(a.frustums, **{k.name: merged(getattr(a.frustums, k.name), getattr(b.frustums, k.name))
                                           for k in dataclasses.fields(a.frustums)})
    out = a.replace(frustums=f, spacing_starts=merged(a.spacing_starts, b.spacing_starts),
                    spacing_ends=merged(a.spacing_ends, b.spacing_ends),
                    camera_indices=merged(a.camera_indices, b.camera_indices), times=merged(a.times, b.times))
    return out.replace(deltas=f.ends - f.starts)


def neus_sampler(
    bundle: RayBundle,
    sdf_fn: Callable[[RaySamples], torch.Tensor],
    num_samples: int = 64,
    num_samples_importance: int = 64,
    num_upsample_steps: int = 4,
    base_variance: float = 64.0,
    jitters: Optional[Sequence[torch.Tensor]] = None,
) -> RaySamples:
    """NeuS's SDF-guided hierarchical sampling: uniform samples, then
    `num_upsample_steps` rounds that each take the alphas of the SDF's
    s-density (inverse variance `base_variance * 2^round`, from adjacent SDF
    estimates), resample `num_samples_importance / num_upsample_steps` bins by
    their weights and merge them in, sorted. `jitters`: the uniform draws of
    the first round and of each upsampling round (1 + num_upsample_steps
    tensors of [R, 1] or [R, n + 1]), or None for bin centres."""
    jitters = [None] * (1 + num_upsample_steps) if jitters is None else list(jitters)
    samples = spaced_sampler(bundle, num_samples, UNIFORM, jitter=jitters[0])
    n_extra = num_samples_importance // num_upsample_steps
    for step in range(num_upsample_steps):
        sdf = sdf_fn(samples).detach()  # [R, S, 1]
        inv_s = base_variance * 2**step
        prev_sdf, next_sdf = sdf[..., :-1, :], sdf[..., 1:, :]
        deltas = samples.deltas[..., :-1, :]
        mid_sdf = (prev_sdf + next_sdf) * 0.5
        cos_val = ((next_sdf - prev_sdf) / deltas.clamp_min(1e-6)).clamp(-1e3, 0.0)
        prev_esti = mid_sdf - cos_val * deltas * 0.5
        next_esti = mid_sdf + cos_val * deltas * 0.5
        prev_cdf = torch.sigmoid(prev_esti * inv_s)
        next_cdf = torch.sigmoid(next_esti * inv_s)
        alphas = ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)
        weights, _ = RaySamples.get_weights_and_transmittance_from_alphas(alphas)
        new = pdf_sampler(bundle, samples, weights, n_extra, UNIFORM, jitter=jitters[1 + step],
                          histogram_padding=1e-5)
        samples = merge_ray_samples_sorted(samples, new)
    return samples


def proposal_sampler(
    bundle: RayBundle,
    density_fns: Sequence[Callable[[RaySamples], torch.Tensor]],
    num_proposal_samples_per_ray: Tuple[int, ...],
    num_nerf_samples_per_ray: int,
    spacing: Spacing = UNIFORM_LIN_DISP_PIECEWISE,
    jitters: Optional[Sequence[torch.Tensor]] = None,
    anneal: float = 1.0,
    stop_proposal_grad: bool = False,
) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """Hierarchical proposal sampling: a spaced round, then one PDF round per
    further level, each resampling by the previous level's weights.
    density_fns[i] takes full RaySamples and returns [R, S, 1] density.
    `jitters`: one tensor of uniform draws per level (len(density_fns) + 1), or
    None for the eval path. Returns (final samples, the proposal levels'
    weights, the proposal levels' samples)."""
    n = len(density_fns)
    weights_list: List[torch.Tensor] = []
    samples_list: List[RaySamples] = []
    weights = None
    ray_samples = None
    if jitters is None:
        jitters = [None] * (n + 1)

    for i_level in range(n + 1):
        is_prop = i_level < n
        num_samples = num_proposal_samples_per_ray[i_level] if is_prop else num_nerf_samples_per_ray
        if i_level == 0:
            ray_samples = spaced_sampler(bundle, num_samples, spacing, jitter=jitters[0])
        else:
            ray_samples = pdf_sampler(bundle, ray_samples, weights**anneal, num_samples, spacing,
                                      jitter=jitters[i_level])
        if is_prop:
            density = density_fns[i_level](ray_samples)
            if stop_proposal_grad:
                density = density.detach()
            weights = ray_samples.get_weights(density)
            weights_list.append(weights)
            samples_list.append(ray_samples)

    return ray_samples, weights_list, samples_list
