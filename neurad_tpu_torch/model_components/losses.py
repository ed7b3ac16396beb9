"""Loss terms (torch port of `neurad_tpu/model_components/losses.py`): the ones
SplatAD's camera and lidar losses use. The ray-based models' terms (interlevel,
distortion, depth-ranking, ...) arrive with the NeuRAD slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
