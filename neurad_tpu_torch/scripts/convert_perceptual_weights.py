"""Convert torch perceptual-metric weights to the .npz files the port loads
(the port's own copy of `neurad_tpu/scripts/convert_perceptual_weights.py`;
both packages read the same files):

  vgg19      torchvision `vgg19(weights=...).features.state_dict()` -> npz for
             NEURAD_TPU_VGG19_WEIGHTS (training perceptual loss + fallback LPIPS).
  lpips      the `lpips` package's `LPIPS(net='vgg')` state_dict (VGG16 backbone
             + lin heads) -> npz for NEURAD_TPU_LPIPS_WEIGHTS.
  inception  pytorch-fid's InceptionV3 (or torchvision `inception_v3`)
             state_dict -> npz for NEURAD_TPU_INCEPTION_WEIGHTS.

Nothing is downloaded: run this where the weight files are, and export the
variable. Every converted file is checked against the architecture's shapes
here and again when it loads, so a wrong or truncated file fails loudly.

Usage:
  python -m neurad_tpu_torch.scripts.convert_perceptual_weights vgg19 vgg19_features.pth out.npz
  python -m neurad_tpu_torch.scripts.convert_perceptual_weights lpips lpips_vgg.pth out.npz
  python -m neurad_tpu_torch.scripts.convert_perceptual_weights inception pt_inception.pth out.npz

The .pth may be a raw state_dict or a checkpoint dict containing one.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from neurad_tpu_torch.model_components.inception import conv_specs
from neurad_tpu_torch.model_components.lpips_exact import _HEAD_CH, _VGG16_CONVS

# VGG19 `features` conv indices used by the perceptual loss (conv1_1..conv5_1)
_VGG19_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
_VGG19_CH = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512]


def _to_numpy_state(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("state_dict", "model", "net"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "detach")}


def _strip_prefix(state: Dict[str, np.ndarray], prefixes=("module.", "net.")) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def convert_vgg19(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    state = _strip_prefix(state)
    out = {}
    in_ch = 3
    for idx, ch in zip(_VGG19_IDX, _VGG19_CH):
        # accept both `features.N.weight` (full model) and `N.weight` (features-only)
        key = f"features.{idx}.weight" if f"features.{idx}.weight" in state else f"{idx}.weight"
        bkey = key.replace("weight", "bias")
        w, b = state[key], state[bkey]
        if w.shape != (ch, in_ch, 3, 3):
            raise ValueError(f"vgg19 {key}: {w.shape} != {(ch, in_ch, 3, 3)}")
        out[f"features.{idx}.weight"] = w.astype(np.float32)
        out[f"features.{idx}.bias"] = b.astype(np.float32)
        in_ch = ch
    return out


def convert_lpips(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """lpips.LPIPS(net='vgg') state_dict: `net.slice{i}.{j}.weight` or flat
    torchvision-style + `lin{i}.model.1.weight` heads."""
    state = _strip_prefix(state, prefixes=("module.",))
    out = {}
    # backbone: lpips stores it as net.slice1..slice5 with ORIGINAL vgg16
    # feature indices inside each slice, so `net.slice2.5.weight` is
    # features.5; strip the slice wrapper.
    for k, v in state.items():
        if k.startswith("net.slice"):
            idx = k.split(".")[2]
            out[f"features.{idx}.{k.split('.')[-1]}"] = v.astype(np.float32)
        elif k.startswith("features."):
            out[k] = v.astype(np.float32)
    for fi, in_ch, out_ch in _VGG16_CONVS:
        w = out.get(f"features.{fi}.weight")
        if w is None:
            raise ValueError(f"lpips: missing backbone conv features.{fi}")
        if w.shape != (out_ch, in_ch, 3, 3):
            raise ValueError(f"lpips features.{fi}: {w.shape} != {(out_ch, in_ch, 3, 3)}")
    for i, c in enumerate(_HEAD_CH):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in state:
                w = state[cand]
                break
        else:
            raise ValueError(f"lpips: missing linear head lin{i}")
        if w.shape != (1, c, 1, 1):
            raise ValueError(f"lpips lin{i}: {w.shape} != {(1, c, 1, 1)}")
        out[f"lin{i}.model.1.weight"] = w.astype(np.float32)
    return out


def convert_inception(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    state = _strip_prefix(state)
    out = {}
    for name, in_ch, out_ch, k, _s, _p in conv_specs():
        w = state[f"{name}.conv.weight"]
        if w.shape != (out_ch, in_ch, k[0], k[1]):
            raise ValueError(f"inception {name}: {w.shape} != {(out_ch, in_ch, k[0], k[1])}")
        out[f"{name}.conv.weight"] = w.astype(np.float32)
        for part in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.bn.{part}"] = state[f"{name}.bn.{part}"].astype(np.float32)
    return out


CONVERTERS = {"vgg19": convert_vgg19, "lpips": convert_lpips, "inception": convert_inception}


def entrypoint(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("kind", choices=sorted(CONVERTERS))
    ap.add_argument("src", help=".pth torch state_dict / checkpoint")
    ap.add_argument("dst", help="output .npz")
    args = ap.parse_args(argv)
    state = _to_numpy_state(args.src)
    out = CONVERTERS[args.kind](state)
    np.savez(args.dst, **out)
    total = sum(v.size for v in out.values())
    print(f"wrote {args.dst}: {len(out)} arrays, {total / 1e6:.1f} M params")


if __name__ == "__main__":
    sys.exit(entrypoint())
