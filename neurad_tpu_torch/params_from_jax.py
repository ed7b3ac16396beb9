"""Bridge from the JAX package's flax parameter tree to the port's state dict.

The tree's leaves are numpy arrays (`jax.tree.map(np.asarray, params)`), so
this module needs neither JAX nor the JAX package. Layout changes:

  Conv kernels   flax HWIO [kh, kw, in, out] -> torch OIHW [out, in, kh, kw]
  Dense kernels  flax [in, out]              -> torch Linear [out, in]

Flax names convs in creation order: a BasicBlock whose input width differs
from its output creates its 1x1 residual conv first (Conv_0), then the two
kxk convs; otherwise the kxk convs are Conv_0 and Conv_1.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _t(p["kernel"]).permute(3, 2, 0, 1).contiguous(),
        f"{prefix}.bias": _t(p["bias"]),
    }


def _dense(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["kernel"]).T.contiguous(), f"{prefix}.bias": _t(p["bias"])}


def _basic_block(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    convs = sorted((k for k in p if k.startswith("Conv_")), key=lambda k: int(k.split("_")[1]))
    names = ["res", "conv1", "conv2"] if len(convs) == 3 else ["conv1", "conv2"]
    out = {}
    for flax_name, name in zip(convs, names):
        out.update(_conv(f"{prefix}.{name}", p[flax_name]))
    for i, norm in enumerate(sorted(k for k in p if k.startswith("GroupNorm_"))):
        out[f"{prefix}.norm{i + 1}.weight"] = _t(p[norm]["scale"])
        out[f"{prefix}.norm{i + 1}.bias"] = _t(p[norm]["bias"])
    return out


def splatad_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params of `neurad_tpu.models.splatad.SplatADModel` (the dict under
    or including the "params" key) -> state dict of the port's SplatADModel.

    Any tree shaped like the parameters maps the same way, so this also
    carries the JAX package's gradients and optax's Adam moments (`mu`, `nu`)
    into the port's parameter names and layouts."""
    p = tree["params"] if "params" in tree else tree
    sd = {name: _t(p[name]) for name in ("means", "scales", "quats", "features", "opacities")}
    for name, value in p.get("actors", {}).items():  # absent in a scene without actors
        sd[f"actors.{name}"] = _t(value)

    dec = p["rgb_decoder"]
    blocks = sorted((k for k in dec if k.startswith("BasicBlock_")), key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(blocks):
        sd.update(_basic_block(f"rgb_decoder.blocks.{i}", dec[name]))
    sd.update(_conv("rgb_decoder.head", dec["Conv_0"]))

    for name, layer in p["lidar_decoder"].items():
        sd.update(_dense(f"lidar_decoder.{name}", layer))
    sd["appearance_embedding.weight"] = _t(p["appearance_embedding"]["embedding"])

    for name, value in p.get("camera_optimizer", {}).items():
        sd[f"camera_optimizer.{name}"] = _t(value)
    for name, value in p.get("camera_velocity_optimizer", {}).items():
        sd[f"camera_velocity_optimizer.{name}"] = _t(value)
    return sd
