"""Perceptual eval metrics: LPIPS and FID, and the shifts of the AD novel-view
FID suite (torch port of `neurad_tpu/utils/eval_metrics.py`).

Two modes, as in the JAX package:
- Exact (comparable with torchmetrics): NEURAD_TPU_LPIPS_WEIGHTS names a
  converted lpips-vgg16 .npz and NEURAD_TPU_INCEPTION_WEIGHTS a converted
  pytorch-fid InceptionV3 .npz (`scripts/convert_perceptual_weights.py`).
  LPIPS then runs the VGG16 and linear-head graph
  (`model_components/lpips_exact.py`), FID the 299x299 pool3 protocol
  (`model_components/inception.py`).
- Fallback: without those files the metrics run on the VGG19 backbone of
  `model_components/perceptual.py` (its pretrained weights where
  NEURAD_TPU_VGG19_WEIGHTS names them, else a fixed random network). The
  numbers then serve only to compare runs with each other, and a warning says
  so at every call.

Images are [H, W, 3] or [B, H, W, 3] in [0, 1]. The networks run on the
device they are asked for; the Frechet distance's covariances and matrix root
are host numpy and scipy, as in the JAX package. Loaded weights are kept in
module caches keyed by file (and device).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.model_components.inception import inception_pool3, load_inception_params
from neurad_tpu_torch.model_components.lpips_exact import load_lpips_params, lpips_exact
from neurad_tpu_torch.model_components.perceptual import IMAGENET_MEAN, IMAGENET_STD, Vgg19Slices, load_vgg19_params

FALLBACK_VGG_SEED = 0  # the FID fallback's VGG19 when the caller gives none (JAX: PRNGKey(0))

_EXACT_LPIPS_CACHE: dict = {}
_INCEPTION_CACHE: dict = {}
_FALLBACK_VGG_CACHE: dict = {}


def _cached(cache: dict, env: str, loader, device: torch.device):
    """The weights of the file named by `env`, loaded once per (file,
    device); None when the variable is unset or names no file."""
    path = os.environ.get(env)
    if not path or not os.path.exists(path):
        return None
    key = (path, str(device))
    if key not in cache:
        cache[key] = loader(path, device)
    return cache[key]


def _exact_lpips_params(device: torch.device) -> Optional[dict]:
    return _cached(_EXACT_LPIPS_CACHE, "NEURAD_TPU_LPIPS_WEIGHTS", load_lpips_params, device)


def _inception_params(device: torch.device) -> Optional[dict]:
    return _cached(_INCEPTION_CACHE, "NEURAD_TPU_INCEPTION_WEIGHTS", load_inception_params, device)


def _fallback_vgg(device: torch.device) -> Vgg19Slices:
    """The FID fallback's VGG19 when the caller gives none: drawn from seed
    FALLBACK_VGG_SEED (or NEURAD_TPU_VGG19_WEIGHTS' weights), once per
    device and weight file."""
    key = (str(device), os.environ.get("NEURAD_TPU_VGG19_WEIGHTS"))
    if key not in _FALLBACK_VGG_CACHE:
        _FALLBACK_VGG_CACHE[key] = load_vgg19_params(torch.Generator().manual_seed(FALLBACK_VGG_SEED), device)
    return _FALLBACK_VGG_CACHE[key]


def _warn_fallback(metric: str, env: str) -> None:
    warnings.warn(
        f"{metric}: no pretrained weights ({env} unset/missing) — falling back to "
        "the VGG19 feature statistic. Numbers are RELATIVE-ONLY, not comparable "
        "to torchmetrics. Convert weights with scripts/convert_perceptual_weights.py.",
        stacklevel=3,
    )


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def lpips(vgg: Optional[Vgg19Slices], pred: torch.Tensor, target: torch.Tensor, normalize: bool = True
          ) -> torch.Tensor:
    """LPIPS of two images (or batches) on their device. With
    NEURAD_TPU_LPIPS_WEIGHTS: the exact VGG16 and linear-head graph (`vgg` is
    not used). Otherwise, with a warning: unit-normalised VGG19 feature
    differences, averaged over the map and summed over the five slices
    (uniform weights in place of the learned heads)."""
    exact = _exact_lpips_params(pred.device)
    if exact is not None:
        return lpips_exact(exact, pred, target)
    _warn_fallback("LPIPS", "NEURAD_TPU_LPIPS_WEIGHTS")
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    if normalize:
        pred, target = _normalize(pred), _normalize(target)
    feats = vgg(torch.cat([pred, target], dim=0))
    n = pred.shape[0]
    total = 0.0
    for f in feats:
        f = f / torch.linalg.norm(f, dim=-1, keepdim=True).clamp_min(1e-10)
        total = total + torch.mean((f[:n] - f[n:]) ** 2, dim=(1, 2, 3))
    return torch.mean(total)


def _image(img, device: torch.device) -> torch.Tensor:
    """[H, W, 3] numpy array or tensor -> [1, H, W, 3] fp32 on `device`."""
    return torch.as_tensor(img, device=device).float()[None]


def _features_for_fid(vgg: Vgg19Slices, images: Sequence, device: torch.device) -> np.ndarray:
    """The deepest VGG19 slice, averaged over the map, per image -> [n, 512]
    (host)."""
    feats = []
    for img in images:
        out = vgg(_normalize(_image(img, device)))[-1]
        feats.append(out.mean(dim=(1, 2))[0].cpu().numpy())
    return np.stack(feats)


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """Frechet distance between two gaussians (the FID formula)."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def _inception_features(params: dict, images: Sequence, device: torch.device) -> np.ndarray:
    """FID-protocol features per image: 299x299 bilinear resize, [-1, 1]
    scaling, pool3 -> [n, 2048] (host)."""
    return np.stack([inception_pool3(params, _image(img, device))[0].cpu().numpy() for img in images])


def _statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return feats.mean(0), np.cov(feats, rowvar=False) + 1e-6 * np.eye(feats.shape[1])


def fid(real_images: Sequence, fake_images: Sequence, vgg: Optional[Vgg19Slices] = None, device="cuda") -> float:
    """FID between two lists of [H, W, 3] images in [0, 1] (numpy arrays or
    tensors), their features computed on `device`. With
    NEURAD_TPU_INCEPTION_WEIGHTS: the pytorch-fid protocol (299x299,
    InceptionV3 pool3). Otherwise, with a warning: the Frechet distance of
    pooled VGG19 features (`vgg`, or the fallback network of seed
    FALLBACK_VGG_SEED), relative only. One image per list gives NaN (its
    covariance), as in the JAX package."""
    device = resolve_device(device)
    with torch.no_grad():
        inception = _inception_params(device)
        if inception is not None:
            fr, ff = _inception_features(inception, real_images, device), _inception_features(inception, fake_images,
                                                                                                device)
        else:
            _warn_fallback("FID", "NEURAD_TPU_INCEPTION_WEIGHTS")
            vgg = vgg if vgg is not None else _fallback_vgg(device)
            fr, ff = _features_for_fid(vgg, real_images, device), _features_for_fid(vgg, fake_images, device)
    (mu1, s1), (mu2, s2) = _statistics(fr), _statistics(ff)
    return frechet_distance(mu1, s1, mu2, s2)


def fid_suite_shifts(lane_shift_sign: int = 1) -> Dict[str, Tuple[float, float]]:
    """The AD novel-view FID's camera shifts (lateral, vertical) in metres:
    lane shifts of 2 and 3 m (signed per sequence), vertical 1 m."""
    return {
        "lane_shift_2m": (lane_shift_sign * 2.0, 0.0),
        "lane_shift_3m": (lane_shift_sign * 3.0, 0.0),
        "vertical_shift_1m": (0.0, 1.0),
    }
