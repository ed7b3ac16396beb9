"""Loss terms (torch port of `neurad_tpu/model_components/losses.py`): the ones
SplatAD's camera and lidar losses use, and NeuRAD's over the sample
histograms (MipNeRF-360 interlevel and distortion, ZipNeRF's anti-aliased
interlevel). Sample histograms come in as (sdist [R, S+1], weights [R, S])
pairs. The JAX package's `take_along_small` is `torch.gather` here (the same
values and gradients); its `searchsorted_dense` stays a count of the entries
below each query (`_searchsorted`), which `torch.searchsorted` equals only on
sorted input. The lidar nerfacto model adds gradient scaling by distance and
the DS-NeRF depth loss; SparseNeRF's depth ranking and the Urban Radiance
Fields depth loss complete the set.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-7


def ray_samples_to_sdist(spacing_starts: torch.Tensor, spacing_ends: torch.Tensor) -> torch.Tensor:
    """[R, S, 1], [R, S, 1] -> bin edges [R, S + 1]."""
    return torch.cat([spacing_starts[..., 0], spacing_ends[..., -1:, 0]], dim=-1)


def _searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """a [..., N], v [..., M] -> [..., M] int64: the count of a's entries < v
    ("left") or <= v ("right"). On a sorted `a` that is `torch.searchsorted`;
    the ZipNeRF loss also searches its blurred step function's edges with the
    interval's own bounds prepended and appended, which are not sorted, and
    there only the count is the JAX package's result."""
    if side == "right":
        return torch.sum(a[..., None, :] <= v[..., :, None], dim=-1)
    return torch.sum(a[..., None, :] < v[..., :, None], dim=-1)


# ---------------------------------------------------------------------------
# MipNeRF-360 interlevel + distortion
# ---------------------------------------------------------------------------


def _outer(t0_lo, t0_hi, t1_lo, t1_hi, y1):
    """Summed y1 over the intervals of t1 covering each interval of t0."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    idx_lo = (_searchsorted(t1_lo, t0_lo, side="right") - 1).clamp(0, y1.shape[-1] - 1)
    idx_hi = _searchsorted(t1_hi, t0_hi, side="left").clamp(0, y1.shape[-1])
    return torch.gather(cy1, -1, idx_hi) - torch.gather(cy1, -1, idx_lo)


def lossfun_outer(t: torch.Tensor, w: torch.Tensor, t_env: torch.Tensor, w_env: torch.Tensor) -> torch.Tensor:
    """Histogram-bound violation."""
    w_outer = _outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return (w - w_outer).clamp_min(0.0) ** 2 / (w + EPS)


def interlevel_loss(weights_list: Sequence[torch.Tensor], sdist_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """MipNeRF-360 proposal loss. weights_list[i]: [R, S_i, 1]; sdist_list[i]:
    [R, S_i + 1]; the last entry is the field's."""
    c = sdist_list[-1].detach()
    w = weights_list[-1][..., 0].detach()
    loss = 0.0
    for sdist, weights in zip(sdist_list[:-1], weights_list[:-1]):
        loss += torch.mean(lossfun_outer(c, w, sdist, weights[..., 0]))
    return loss


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-ray distortion."""
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(weights_list: Sequence[torch.Tensor], sdist_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """MipNeRF-360 distortion on the final samples."""
    return torch.mean(lossfun_distortion(sdist_list[-1], weights_list[-1][..., 0]))


# ---------------------------------------------------------------------------
# ZipNeRF anti-aliased interlevel
# ---------------------------------------------------------------------------


def _blur_stepfun(x: torch.Tensor, y: torch.Tensor, r: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box-blur a step function."""
    xr_cat = torch.cat([x - r, x + r], dim=-1)
    xr_idx = torch.argsort(xr_cat, dim=-1, stable=True)
    xr = torch.gather(xr_cat, -1, xr_idx)
    y1 = (torch.cat([y, torch.zeros_like(y[..., :1])], dim=-1)
          - torch.cat([torch.zeros_like(y[..., :1]), y], dim=-1)) / (2.0 * r)
    y2 = torch.gather(torch.cat([y1, -y1], dim=-1), -1, xr_idx[..., :-1])
    yr = torch.cumsum((xr[..., 1:] - xr[..., :-1]) * torch.cumsum(y2, dim=-1), dim=-1).clamp_min(0.0)
    yr = torch.cat([torch.zeros_like(yr[..., :1]), yr], dim=-1)
    return xr, yr


def _sorted_interp_quad(x, xp, fpdf, fcdf):
    """Piecewise-quadratic CDF interpolation."""
    right_idx = _searchsorted(xp, x, side="left")
    left_idx = (right_idx - 1).clamp_min(0)
    right_idx = right_idx.clamp_max(xp.shape[-1] - 1)
    xp0 = torch.gather(xp, -1, left_idx)
    xp1 = torch.gather(xp, -1, right_idx)
    fpdf0 = torch.gather(fpdf, -1, left_idx)
    fpdf1 = torch.gather(fpdf, -1, right_idx)
    fcdf0 = torch.gather(fcdf, -1, left_idx)
    offset = torch.nan_to_num((x - xp0) / (xp1 - xp0)).clamp(0.0, 1.0)
    return fcdf0 + (x - xp0) * (fpdf0 + fpdf1 * offset + fpdf0 * (1.0 - offset)) * 0.5


def zipnerf_interlevel_loss(
    weights_list: Sequence[torch.Tensor], sdist_list: Sequence[torch.Tensor], per_ray: bool = False
) -> torch.Tensor:
    """Anti-aliased interlevel loss, mean-reduced; `per_ray` returns the
    per-ray values [R] instead of the mean (for chunked evaluation)."""
    pulse_widths = [0.03, 0.003]
    c = sdist_list[-1].detach()
    w = weights_list[-1][..., 0].detach()
    accum_w = torch.sum(w, dim=-1, keepdim=True)
    w = torch.cat([w[..., :-1], w[..., -1:] + (1.0 - accum_w)], dim=-1)

    w_norm = w / (c[..., 1:] - c[..., :-1])
    loss = 0.0
    for i, (sdist, weights) in enumerate(zip(sdist_list[:-1], weights_list[:-1])):
        cp = sdist
        wp = weights[..., 0]
        c_, w_ = _blur_stepfun(c, w_norm, pulse_widths[min(i, len(pulse_widths) - 1)])

        area = 0.5 * (w_[..., 1:] + w_[..., :-1]) * (c_[..., 1:] - c_[..., :-1])
        cdf = torch.cat([torch.zeros_like(area[..., :1]), torch.cumsum(area, dim=-1)], dim=-1)

        c_ = torch.cat([torch.zeros_like(c_[..., :1]), c_, torch.ones_like(c_[..., :1])], dim=-1)
        w_ = torch.cat([torch.zeros_like(w_[..., :1]), w_, torch.zeros_like(w_[..., :1])], dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)

        cdf_interp = _sorted_interp_quad(cp, c_, w_, cdf)
        w_s = torch.diff(cdf_interp, dim=-1)
        ray_vals = torch.sum((w_s - wp).clamp_min(0.0) ** 2 / (wp + 1e-5), dim=-1)
        loss = loss + (ray_vals if per_ray else torch.mean(ray_vals))
    return loss


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over masked elements; 0 when the mask is empty."""
    denom = mask.sum().clamp_min(1.0)
    return torch.where(mask, x, torch.zeros_like(x)).sum() / denom


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """q-quantile of the masked elements of x, with linear interpolation
    between the bracketing order statistics (torch.quantile's default).
    Static-shape form of the JAX package: masked-out entries sort to +inf and
    the position is taken from the mask's count."""
    flat = torch.where(mask.reshape(-1), x.reshape(-1), torch.full_like(x.reshape(-1), float("inf")))
    srt = torch.sort(flat).values
    n = mask.sum().clamp_min(1)
    pos = q * (n - 1).to(torch.float32)
    lo = torch.floor(pos).long().clamp(0, flat.shape[0] - 1)
    hi = torch.minimum((lo + 1).clamp_min(0), n - 1)
    frac = pos - lo.to(torch.float32)
    # where frac == 0, srt[hi] may be +inf (masked): keep it out of the lerp
    return torch.where(frac > 0, srt[lo] * (1.0 - frac) + srt[hi] * frac, srt[lo])


class BatchTerms:
    """How a loss reduces over its batch: in one process, over the batch it
    is given (NeuRAD's `compute_losses` by default).
    `parallel/sharding.GlobalBatchTerms` reduces the same terms over a
    data-parallel world's global batch, each rank holding its own rows."""

    @staticmethod
    def mean(x: torch.Tensor) -> torch.Tensor:
        """The mean of x (a share of the batch equal on every rank)."""
        return torch.mean(x)

    @staticmethod
    def of_mean(value: torch.Tensor) -> torch.Tensor:
        """A value that is already a mean over such a share (VGG's loss)."""
        return value

    @staticmethod
    def ratio(total: torch.Tensor, count: float) -> torch.Tensor:
        """A sum over the batch over its count of rows."""
        return total / count

    masked_mean = staticmethod(masked_mean)
    masked_quantile = staticmethod(masked_quantile)

    @staticmethod
    def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        return psnr(pred, gt)


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val**2 / mse.clamp_min(1e-12))


def ssim(
    pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0, filter_size: int = 11, sigma: float = 1.5
) -> torch.Tensor:
    """SSIM with separable gaussian windows and valid padding (torchmetrics
    defaults k1=0.01, k2=0.03). Inputs [H, W, C] in [0, max_val]."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    half = filter_size // 2
    offs = torch.arange(-half, half + 1, dtype=pred.dtype, device=pred.device)
    g = torch.exp(-(offs**2) / (2 * sigma**2))
    g = g / g.sum()

    def blur(img):
        x = img.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
        x = F.conv2d(x, g.reshape(1, 1, -1, 1))
        x = F.conv2d(x, g.reshape(1, 1, 1, -1))
        return x[:, 0].permute(1, 2, 0)

    mu_p, mu_g = blur(pred), blur(gt)
    mu_p2, mu_g2, mu_pg = mu_p**2, mu_g**2, mu_p * mu_g
    sigma_p2 = blur(pred**2) - mu_p2
    sigma_g2 = blur(gt**2) - mu_g2
    sigma_pg = blur(pred * gt) - mu_pg
    num = (2 * mu_pg + c1) * (2 * sigma_pg + c2)
    den = (mu_p2 + mu_g2 + c1) * (sigma_p2 + sigma_g2 + c2)
    return torch.mean(num / den)


def gradient_scaling_by_distance_squared(values: torch.Tensor, ray_dist: torch.Tensor) -> torch.Tensor:
    """The values unchanged; their gradient scaled by clamp(dist^2, 0, 1)."""
    scale = torch.clamp(ray_dist**2, 0.0, 1.0)
    return values * scale + (values * (1.0 - scale)).detach()


def ds_nerf_depth_loss(weights: torch.Tensor, termination_depth: torch.Tensor, steps: torch.Tensor,
                       lengths: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """DS-NeRF's depth likelihood: weights, steps, lengths [R, S, 1],
    termination_depth [R, 1]; rays of depth 0 count as zeros in the mean."""
    depth_mask = termination_depth > 0
    loss = -torch.log(weights + EPS) * torch.exp(-((steps - termination_depth[:, None]) ** 2) / (2 * sigma)) * lengths
    loss = torch.sum(loss, dim=-2) * depth_mask
    return torch.mean(loss)


def depth_ranking_loss(rendered_depth: torch.Tensor, gt_depth: torch.Tensor) -> torch.Tensor:
    """SparseNeRF's depth ranking loss on pair-sampled rays (pairs
    interleaved, an odd last ray dropped): the mean margin violation where a
    pair's rendered order disagrees with its ground-truth order."""
    m = 1e-4
    n = (rendered_depth.shape[0] // 2) * 2
    rendered_depth, gt_depth = rendered_depth[:n], gt_depth[:n]
    dpt_diff = gt_depth[::2] - gt_depth[1::2]
    out_diff = rendered_depth[::2] - rendered_depth[1::2] + m
    differing = torch.sign(dpt_diff) != torch.sign(out_diff)
    return masked_mean(out_diff * torch.sign(out_diff), differing)


def urban_radiance_field_depth_loss(weights: torch.Tensor, termination_depth: torch.Tensor,
                                    predicted_depth: torch.Tensor, steps: torch.Tensor, sigma: torch.Tensor
                                    ) -> torch.Tensor:
    """Urban Radiance Fields' depth loss: the expected depth's squared error
    plus the line-of-sight term (the weights before the return against a
    normalised gaussian around it), over rays with a return."""
    depth_mask = termination_depth > 0
    expected_depth_loss = (termination_depth - predicted_depth) ** 2
    line_of_sight_ends = termination_depth[:, None] - EPS
    target = torch.exp(-((steps - termination_depth[:, None]) ** 2) / (2 * sigma))
    target = target / torch.sum(target, dim=-2, keepdim=True).clamp_min(EPS)
    before = steps < line_of_sight_ends
    line_of_sight_loss = torch.sum(torch.where(before, (weights - target) ** 2, torch.zeros_like(weights)), dim=-2)
    return torch.mean((expected_depth_loss + line_of_sight_loss) * depth_mask)
