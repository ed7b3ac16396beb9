"""Exact LPIPS (Zhang et al. 2018): VGG16 and learned linear heads (torch port
of `neurad_tpu/model_components/lpips_exact.py`).

  1. inputs in [0, 1] are mapped to [-1, 1], then shifted and scaled per
     channel by the paper's fixed constants;
  2. VGG16 activations after torchvision `vgg16.features` indices 3, 8, 15,
     22 and 29 (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3);
  3. each activation unit-normalised over channels (eps added to the norm);
  4. the squared difference weighted by the layer's non-negative linear head
     (a 1x1 convolution to one channel);
  5. the spatial mean, summed over the five layers, averaged over the batch.

Weights load from an .npz written by
`neurad_tpu_torch/scripts/convert_perceptual_weights.py` (torchvision
`features.N.weight/bias` keys and lpips `lin{i}.model.1.weight` heads), named
by NEURAD_TPU_LPIPS_WEIGHTS in `utils/eval_metrics.py`. Images cross the
boundary NHWC, as in the JAX package, and run NCHW inside.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the paper's fixed input normalisation (lpips ScalingLayer constants)
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

# torchvision vgg16.features conv indices and channels; LPIPS taps the relu
# after features index {3, 8, 15, 22, 29}
_VGG16_CONVS: List[Tuple[int, int, int]] = [  # (features index, in channels, out channels)
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
_TAP_AFTER = {3, 8, 15, 22, 29}  # features indices whose relu output is tapped
_POOL_AT = {4, 9, 16, 23}  # max-pool positions in vgg16.features
_HEAD_CH = [64, 128, 256, 512, 512]


def load_lpips_params(path: str, device="cpu") -> Dict[str, list]:
    """Converted LPIPS weights -> {'convs': [(w [out, in, 3, 3], b)] * 13,
    'heads': [w [C]] * 5}, fp32 on `device`. Every shape is checked."""
    raw = np.load(path)
    as_tensor = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    convs = []
    for idx, in_ch, out_ch in _VGG16_CONVS:
        w = raw[f"features.{idx}.weight"]
        if w.shape != (out_ch, in_ch, 3, 3):
            raise ValueError(f"features.{idx}: {w.shape} != {(out_ch, in_ch, 3, 3)}")
        convs.append((as_tensor(w), as_tensor(raw[f"features.{idx}.bias"])))
    heads = []
    for i, c in enumerate(_HEAD_CH):
        w = raw[f"lin{i}.model.1.weight"]
        if w.shape != (1, c, 1, 1):
            raise ValueError(f"lin{i}: {w.shape} != {(1, c, 1, 1)}")
        heads.append(as_tensor(w.reshape(c)))
    return {"convs": convs, "heads": heads}


def _vgg16_taps(convs, x: torch.Tensor) -> List[torch.Tensor]:
    """vgg16.features in order on NCHW `x` -> the five tapped relu activations."""
    taps = []
    ci = 0
    for fi in range(30):  # features indices 0..29
        if fi in _POOL_AT:
            x = F.max_pool2d(x, 2, 2)
        elif fi == _VGG16_CONVS[min(ci, 12)][0]:
            w, b = convs[ci]
            x = F.conv2d(x, w, b, padding=1)
            ci += 1
        else:
            x = F.relu(x)
            if fi in _TAP_AFTER:
                taps.append(x)
    return taps


def lpips_exact(params: Dict, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """LPIPS(pred, target): [B, H, W, 3] or [H, W, 3] images in [0, 1] -> a
    scalar on their device (torchmetrics' normalize=True)."""
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    both = torch.cat([pred, target], dim=0).float().permute(0, 3, 1, 2)
    shift = torch.as_tensor(_SHIFT, device=both.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=both.device)[:, None, None]
    both = (both * 2.0 - 1.0 - shift) / scale
    n = pred.shape[0]
    total = 0.0
    for f, head in zip(_vgg16_taps(params["convs"], both), params["heads"]):
        # lpips normalize_tensor: eps added to the norm, not under the root
        f = f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True)) + 1e-10)
        val = torch.sum((f[:n] - f[n:]) ** 2 * head[:, None, None], dim=1)  # [B, H, W]
        total = total + val.mean(dim=(1, 2))
    return total.mean()
