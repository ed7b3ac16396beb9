"""VGG19 perceptual loss, pix2pixHD style (torch port of
`neurad_tpu/model_components/perceptual.py`).

`Vgg19Slices` is VGG19's feature stack cut at relu5_1, returning the five
slice activations. Images cross the boundary NHWC, as in the JAX package, and
run NCHW inside. Pretrained weights load from the file named by
NEURAD_TPU_VGG19_WEIGHTS (an .npz of torchvision's `vgg19.features` state
dict) when it exists; otherwise the network is a fixed random one drawn with
flax's default convolution init (`lecun_normal`: a normal truncated at two
standard deviations, variance 1 / fan-in; zero biases) from an explicit
generator. Nothing is downloaded.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# conv output channels per slice (relu1_1, relu2_1, relu3_1, relu4_1, relu5_1)
_SLICES = [[64], [64, 128], [128, 256], [256, 256, 256, 512], [512, 512, 512, 512]]
# whether a 2x2 max-pool precedes the conv (VGG19's layer order)
_POOL_BEFORE = [[False], [False, True], [False, True], [False, False, False, True], [False, False, False, True]]
# torchvision's vgg19.features indices of conv1_1 .. conv5_1
_TORCHVISION_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
# the standard deviation of a unit-variance normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class Vgg19Slices(nn.Module):
    """VGG19 up to relu5_1. `forward` takes [B, H, W, 3] and returns the five
    slice activations [B, h, w, c]. Convolutions are `conv_0` .. `conv_12`."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        in_ch = 3
        for i, out_ch in enumerate(c for chans in _SLICES for c in chans):
            conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
            std = math.sqrt(1.0 / (in_ch * 9)) / _TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(conv.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
                conv.bias.zero_()
            setattr(self, f"conv_{i}", conv)
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        outs = []
        i = 0
        for chans, pools in zip(_SLICES, _POOL_BEFORE):
            for _c, pool in zip(chans, pools):
                # no pooling once the map is 1 px (the mean of an empty map would be NaN)
                if pool and min(x.shape[2], x.shape[3]) >= 2:
                    x = F.max_pool2d(x, 2, 2)
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
            outs.append(x.permute(0, 2, 3, 1))
        return outs


def load_vgg19_params(generator: Optional[torch.Generator] = None, device="cpu") -> Vgg19Slices:
    """The perceptual network: random from `generator`, then the pretrained
    weights of NEURAD_TPU_VGG19_WEIGHTS (torchvision `features.N.weight/bias`
    keys) when that file exists. Its parameters do not require grad."""
    vgg = Vgg19Slices(generator)
    path = os.environ.get("NEURAD_TPU_VGG19_WEIGHTS")
    if path and os.path.exists(path):
        raw = np.load(path)
        sd = {}
        for i, li in enumerate(_TORCHVISION_IDX):
            sd[f"conv_{i}.weight"] = torch.from_numpy(np.asarray(raw[f"features.{li}.weight"], np.float32))
            sd[f"conv_{i}.bias"] = torch.from_numpy(np.asarray(raw[f"features.{li}.bias"], np.float32))
        vgg.load_state_dict(sd)
    vgg.requires_grad_(False)
    return vgg.to(device)


def vgg_perceptual_loss(
    vgg: Vgg19Slices,
    pred: torch.Tensor,
    target: torch.Tensor,
    weights: Sequence[float] = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0),
    normalize_inputs: bool = True,
) -> torch.Tensor:
    """Weighted L1 over the five VGG slices. Inputs [B, H, W, 3] in [0, 1];
    the target's features carry no gradient."""
    if normalize_inputs:
        mean = torch.as_tensor(IMAGENET_MEAN, device=pred.device)
        std = torch.as_tensor(IMAGENET_STD, device=pred.device)
        pred = (pred - mean) / std
        target = (target - mean) / std
    feats = vgg(torch.cat([pred, target], dim=0))
    n = pred.shape[0]
    loss = 0.0
    for w, f in zip(weights, feats):
        loss = loss + w * torch.mean(torch.abs(f[:n] - f[n:].detach()))
    return loss
