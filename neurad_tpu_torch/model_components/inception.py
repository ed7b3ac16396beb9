"""Inception-v3 feature graph for FID, the pytorch-fid protocol (torch port of
`neurad_tpu/model_components/inception.py`).

- Images in [0, 1] are resized to 299x299 by `F.interpolate(mode="bilinear",
  align_corners=False)` (half-pixel centres, no antialiasing: the JAX
  package's `antialias=False` resize), then scaled to [-1, 1].
- A BasicConv2d is a bias-free convolution, batch norm (eps 1e-3) and relu;
  the batch norm is folded into the convolution when the weights load.
- pytorch-fid's changes to torchvision's network: every 3x3 stride-1 average
  pool inside a block leaves the padding out of its count
  (`count_include_pad=False`, FIDInceptionA/C/E_1), and Mixed_7c's pool
  branch takes the maximum (FIDInceptionE_2).
- The output is the 2048 pool3 features, averaged over the map.

`load_inception_params` reads an .npz of the torch state dict (pytorch-fid's
or torchvision's `inception_v3`, converted by
`neurad_tpu_torch/scripts/convert_perceptual_weights.py`). There is no random
fallback: FID on random Inception features means nothing, so
`utils/eval_metrics.fid` falls back to the VGG feature statistic and warns.
Images cross the boundary NHWC and run NCHW inside.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# architecture table: (name, in channels, out channels, (kh, kw), (sh, sw), (ph, pw)),
# in torchvision's state-dict naming so converted weights map one to one
# ---------------------------------------------------------------------------


def _block_a(prefix: str, in_ch: int, pool: int) -> List[Tuple]:
    return [
        (f"{prefix}.branch1x1", in_ch, 64, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch5x5_1", in_ch, 48, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch5x5_2", 48, 64, (5, 5), (1, 1), (2, 2)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 64, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch_pool", in_ch, pool, (1, 1), (1, 1), (0, 0)),
    ]


def _block_b(prefix: str, in_ch: int) -> List[Tuple]:
    return [
        (f"{prefix}.branch3x3", in_ch, 384, (3, 3), (2, 2), (0, 0)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 64, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), (2, 2), (0, 0)),
    ]


def _block_c(prefix: str, in_ch: int, c7: int) -> List[Tuple]:
    return [
        (f"{prefix}.branch1x1", in_ch, 192, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7_1", in_ch, c7, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7_2", c7, c7, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch7x7_3", c7, 192, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7dbl_1", in_ch, c7, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch_pool", in_ch, 192, (1, 1), (1, 1), (0, 0)),
    ]


def _block_d(prefix: str, in_ch: int) -> List[Tuple]:
    return [
        (f"{prefix}.branch3x3_1", in_ch, 192, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3_2", 192, 320, (3, 3), (2, 2), (0, 0)),
        (f"{prefix}.branch7x7x3_1", in_ch, 192, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7x3_4", 192, 192, (3, 3), (2, 2), (0, 0)),
    ]


def _block_e(prefix: str, in_ch: int) -> List[Tuple]:
    return [
        (f"{prefix}.branch1x1", in_ch, 320, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3_1", in_ch, 384, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3_2a", 384, 384, (1, 3), (1, 1), (0, 1)),
        (f"{prefix}.branch3x3_2b", 384, 384, (3, 1), (1, 1), (1, 0)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 448, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 448, 384, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), (1, 1), (0, 1)),
        (f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), (1, 1), (1, 0)),
        (f"{prefix}.branch_pool", in_ch, 192, (1, 1), (1, 1), (0, 0)),
    ]


def conv_specs() -> List[Tuple]:
    """Every BasicConv2d in the network, in torchvision state-dict naming."""
    specs: List[Tuple] = [
        ("Conv2d_1a_3x3", 3, 32, (3, 3), (2, 2), (0, 0)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3), (1, 1), (0, 0)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3), (1, 1), (1, 1)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1), (1, 1), (0, 0)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3), (1, 1), (0, 0)),
    ]
    specs += _block_a("Mixed_5b", 192, 32)
    specs += _block_a("Mixed_5c", 256, 64)
    specs += _block_a("Mixed_5d", 288, 64)
    specs += _block_b("Mixed_6a", 288)
    specs += _block_c("Mixed_6b", 768, 128)
    specs += _block_c("Mixed_6c", 768, 160)
    specs += _block_c("Mixed_6d", 768, 160)
    specs += _block_c("Mixed_6e", 768, 192)
    specs += _block_d("Mixed_7a", 768)
    specs += _block_e("Mixed_7b", 1280)
    specs += _block_e("Mixed_7c", 2048)
    return specs


def fold_bn(
    w: np.ndarray, gamma: np.ndarray, beta: np.ndarray, mean: np.ndarray, var: np.ndarray, eps: float = 1e-3
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold batch norm into the bias-free convolution: torch weights [out,
    in, kh, kw] -> (w', b') in the same layout, fp32."""
    scale = gamma / np.sqrt(var + eps)
    w_f = w * scale[:, None, None, None]
    b_f = beta - mean * scale
    return w_f.astype(np.float32), b_f.astype(np.float32)


def load_inception_params(path: str, device="cpu") -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """A converted torch state dict (.npz) -> {name: (w [out, in, kh, kw], b)}
    with batch norm folded, on `device`. Takes torchvision's and pytorch-fid's
    layouts (both `<name>.conv.weight` and `<name>.bn.{weight, bias,
    running_mean, running_var}`); every shape is checked."""
    raw = np.load(path)
    params = {}
    for name, in_ch, out_ch, k, _s, _p in conv_specs():
        w = raw[f"{name}.conv.weight"]
        expect = (out_ch, in_ch, k[0], k[1])
        if w.shape != expect:
            raise ValueError(f"{name}: weight shape {w.shape} != expected {expect}")
        w_f, b_f = fold_bn(
            w, raw[f"{name}.bn.weight"], raw[f"{name}.bn.bias"], raw[f"{name}.bn.running_mean"],
            raw[f"{name}.bn.running_var"],
        )
        params[name] = (torch.as_tensor(w_f, device=device), torch.as_tensor(b_f, device=device))
    return params


# ---------------------------------------------------------------------------
# forward (NCHW)
# ---------------------------------------------------------------------------


def _conv(params, name: str, x: torch.Tensor, stride=(1, 1), pad=(0, 0)) -> torch.Tensor:
    w, b = params[name]
    return F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))


def _maxpool(x, k=3, s=2, p=0):
    return F.max_pool2d(x, k, s, p)


def _avgpool_excl(x):
    """3x3 stride-1 average pool, padding 1, padding left out of the count
    (the pytorch-fid change)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _run_a(params, prefix, x):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b5 = _conv(params, f"{prefix}.branch5x5_2", _conv(params, f"{prefix}.branch5x5_1", x), pad=(2, 2))
    b3 = _conv(params, f"{prefix}.branch3x3dbl_1", x)
    b3 = _conv(params, f"{prefix}.branch3x3dbl_2", b3, pad=(1, 1))
    b3 = _conv(params, f"{prefix}.branch3x3dbl_3", b3, pad=(1, 1))
    bp = _conv(params, f"{prefix}.branch_pool", _avgpool_excl(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _run_b(params, prefix, x):
    b3 = _conv(params, f"{prefix}.branch3x3", x, stride=(2, 2))
    bd = _conv(params, f"{prefix}.branch3x3dbl_1", x)
    bd = _conv(params, f"{prefix}.branch3x3dbl_2", bd, pad=(1, 1))
    bd = _conv(params, f"{prefix}.branch3x3dbl_3", bd, stride=(2, 2))
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _run_c(params, prefix, x):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b7 = _conv(params, f"{prefix}.branch7x7_1", x)
    b7 = _conv(params, f"{prefix}.branch7x7_2", b7, pad=(0, 3))
    b7 = _conv(params, f"{prefix}.branch7x7_3", b7, pad=(3, 0))
    bd = _conv(params, f"{prefix}.branch7x7dbl_1", x)
    bd = _conv(params, f"{prefix}.branch7x7dbl_2", bd, pad=(3, 0))
    bd = _conv(params, f"{prefix}.branch7x7dbl_3", bd, pad=(0, 3))
    bd = _conv(params, f"{prefix}.branch7x7dbl_4", bd, pad=(3, 0))
    bd = _conv(params, f"{prefix}.branch7x7dbl_5", bd, pad=(0, 3))
    bp = _conv(params, f"{prefix}.branch_pool", _avgpool_excl(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _run_d(params, prefix, x):
    b3 = _conv(params, f"{prefix}.branch3x3_1", x)
    b3 = _conv(params, f"{prefix}.branch3x3_2", b3, stride=(2, 2))
    b7 = _conv(params, f"{prefix}.branch7x7x3_1", x)
    b7 = _conv(params, f"{prefix}.branch7x7x3_2", b7, pad=(0, 3))
    b7 = _conv(params, f"{prefix}.branch7x7x3_3", b7, pad=(3, 0))
    b7 = _conv(params, f"{prefix}.branch7x7x3_4", b7, stride=(2, 2))
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _run_e(params, prefix, x, pool_is_max: bool):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b3 = _conv(params, f"{prefix}.branch3x3_1", x)
    b3 = torch.cat([_conv(params, f"{prefix}.branch3x3_2a", b3, pad=(0, 1)),
                    _conv(params, f"{prefix}.branch3x3_2b", b3, pad=(1, 0))], dim=1)
    bd = _conv(params, f"{prefix}.branch3x3dbl_1", x)
    bd = _conv(params, f"{prefix}.branch3x3dbl_2", bd, pad=(1, 1))
    bd = torch.cat([_conv(params, f"{prefix}.branch3x3dbl_3a", bd, pad=(0, 1)),
                    _conv(params, f"{prefix}.branch3x3dbl_3b", bd, pad=(1, 0))], dim=1)
    pooled = _maxpool(x, k=3, s=1, p=1) if pool_is_max else _avgpool_excl(x)
    bp = _conv(params, f"{prefix}.branch_pool", pooled)
    return torch.cat([b1, b3, bd, bp], dim=1)


def inception_pool3(params: Dict, images: torch.Tensor, resize: bool = True) -> torch.Tensor:
    """FID features: [B, H, W, 3] images in [0, 1] -> [B, 2048] pool3
    features on their device. `resize` applies the protocol's bilinear
    299x299 resize; the [-1, 1] scaling is always applied (pytorch-fid's
    `normalize_input`)."""
    x = images.float().permute(0, 3, 1, 2)
    if resize and (x.shape[2] != 299 or x.shape[3] != 299):
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
    x = x * 2.0 - 1.0
    x = _conv(params, "Conv2d_1a_3x3", x, stride=(2, 2))
    x = _conv(params, "Conv2d_2a_3x3", x)
    x = _conv(params, "Conv2d_2b_3x3", x, pad=(1, 1))
    x = _maxpool(x)
    x = _conv(params, "Conv2d_3b_1x1", x)
    x = _conv(params, "Conv2d_4a_3x3", x)
    x = _maxpool(x)
    x = _run_a(params, "Mixed_5b", x)
    x = _run_a(params, "Mixed_5c", x)
    x = _run_a(params, "Mixed_5d", x)
    x = _run_b(params, "Mixed_6a", x)
    x = _run_c(params, "Mixed_6b", x)
    x = _run_c(params, "Mixed_6c", x)
    x = _run_c(params, "Mixed_6d", x)
    x = _run_d(params, "Mixed_7a", x)
    x = _run_e(params, "Mixed_7b", x, pool_is_max=False)
    x = _run_e(params, "Mixed_7c", x, pool_is_max=True)  # FIDInceptionE_2
    return x.mean(dim=(2, 3))
