"""Bridge from the JAX package's flax parameter tree to the port's state dict.

The tree's leaves are numpy arrays (`jax.tree.map(np.asarray, params)`), so
this module needs neither JAX nor the JAX package. Layout changes:

  Conv kernels   flax HWIO [kh, kw, in, out] -> torch OIHW [out, in, kh, kw]
  Dense kernels  flax [in, out]              -> torch Linear [out, in]

Any tree shaped like the parameters maps the same way, so the converters also
carry the JAX package's gradients and optax's Adam moments across.

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
    norms = sorted(k for k in p if k.startswith(("GroupNorm_", "BatchNorm_")))
    for i, norm in enumerate(norms):
        out[f"{prefix}.norm{i + 1}.weight"] = _t(p[norm]["scale"])
        out[f"{prefix}.norm{i + 1}.bias"] = _t(p[norm]["bias"])
    return out


def batch_stats_from_flax(prefix: str, stats: Mapping) -> Dict[str, torch.Tensor]:
    """flax `batch_stats` of an `RGBDecoderCNN` ({BasicBlock_i: {BatchNorm_j:
    {mean, var}}}) -> the running averages of the port's blocks under `prefix`."""
    out = {}
    for name, block in stats.items():
        i = int(name.split("_")[1])
        for j, norm in enumerate(sorted(block)):
            out[f"{prefix}.blocks.{i}.norm{j + 1}.running_mean"] = _t(block[norm]["mean"])
            out[f"{prefix}.blocks.{i}.norm{j + 1}.running_var"] = _t(block[norm]["var"])
    return out


def bottleneck_block_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of a `BottleneckBlock` ({"params": ...} and, with
    norm="batch", {"batch_stats": ...}) -> the state dict of the port's block.
    Its convs in creation order: the 1x1 residual conv when the input width
    differs, then the three convs; its norms GroupNorm_j / BatchNorm_j."""
    p = tree["params"]
    convs = sorted((k for k in p if k.startswith("Conv_")), key=lambda k: int(k.split("_")[1]))
    names = (["res"] if len(convs) == 4 else []) + ["conv1", "conv2", "conv3"]
    sd = {}
    for flax_name, name in zip(convs, names):
        sd.update(_conv(name, p[flax_name]))
    for i, norm in enumerate(sorted(k for k in p if k.startswith(("GroupNorm_", "BatchNorm_")))):
        sd[f"norm{i + 1}.weight"] = _t(p[norm]["scale"])
        sd[f"norm{i + 1}.bias"] = _t(p[norm]["bias"])
    for i, norm in enumerate(sorted(tree.get("batch_stats", {}))):
        sd[f"norm{i + 1}.running_mean"] = _t(tree["batch_stats"][norm]["mean"])
        sd[f"norm{i + 1}.running_var"] = _t(tree["batch_stats"][norm]["var"])
    return sd


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


def _conv_transpose(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    """flax ConvTranspose [kh, kw, in, out] (its default, `transpose_kernel=False`,
    correlates the dilated input with the kernel as stored) -> torch
    ConvTranspose2d [in, out, kh, kw], which scatters the kernel as stored: the
    same taps in the opposite spatial order, so the kernel is flipped."""
    kernel = _t(p["kernel"]).flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return {f"{prefix}.weight": kernel, f"{prefix}.bias": _t(p["bias"])}


def mlp_from_flax(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for name, layer in p.items():
        out.update(_dense(f"{prefix}.{name}", layer))
    return out


def hash_tables_from_flax(prefix: str, p: Mapping, like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """flax params of a `NeuRADHashEncoding` -> the port's, under `prefix`. The JAX package stores each level's table as a 1-D leaf; the port's
    parameter of the same level gives the physical [rows, width] shape."""
    out = {}
    for name in ("static_hash_table", "actor_hash_table"):
        for i, leaf in enumerate(p[name]):
            key = f"{prefix}.{name}.{i}"
            out[key] = _t(leaf).reshape(like[key].shape)
    return out


def neurad_decoder_from_flax(prefix: str, dec: Mapping) -> Dict[str, torch.Tensor]:
    """flax params of `RGBDecoderCNN` -> the port's, under `prefix`. Flax names
    the 1x1 stem Conv_0 and the 1x1 head Conv_1 (creation order)."""
    sd = _conv(f"{prefix}.stem", dec["Conv_0"])
    sd.update(_conv(f"{prefix}.head", dec["Conv_1"]))
    sd.update(_conv_transpose(f"{prefix}.upsample", dec["ConvTranspose_0"]))
    blocks = sorted((k for k in dec if k.startswith("BasicBlock_")), key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(blocks):
        sd.update(_basic_block(f"{prefix}.blocks.{i}", dec[name]))
    return sd


def neurad_params_from_flax(tree: Mapping, like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """flax params of `neurad_tpu.models.neurad.NeuRADModel` (the dict under or
    including the "params" key, leaves as numpy arrays; a "batch_stats" key
    beside it gives a batch-norm decoder's running averages) -> state dict of
    the port's NeuRADModel. `like` is the target model's own state dict: it gives
    the 2-D shapes of the hash tables, which the JAX package keeps as 1-D
    leaves."""
    p = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for name, value in p.get("actors", {}).items():  # absent in a scene without actors
        sd[f"actors.{name}"] = _t(value)
    if "appearance_embedding" in p:
        sd["appearance_embedding.weight"] = _t(p["appearance_embedding"]["embedding"])

    field = p["field"]
    sd.update(hash_tables_from_flax("field.hashgrid", field["hashgrid"], like))
    sd.update(mlp_from_flax("field.mlp_geo", field["mlp_geo"]))
    sd.update(mlp_from_flax("field.mlp_feature", field["mlp_feature"]))
    if "sdf_to_alpha" in field:
        sd["field.sdf_to_alpha.beta"] = _t(field["sdf_to_alpha"]["beta"])

    props = sorted((k for k in p if k.startswith("proposal_field_")), key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(props):
        prop, prefix = p[name], f"proposal_fields.{i}"
        sd[f"{prefix}.density_decoder.weight"] = _t(prop["density_decoder"]["kernel"]).T.contiguous()
        if "mlp" in prop:
            sd.update(mlp_from_flax(f"{prefix}.mlp", prop["mlp"]))
        else:
            sd.update(hash_tables_from_flax(f"{prefix}.hashgrid", prop["hashgrid"], like))

    sd.update(neurad_decoder_from_flax("rgb_decoder", p["rgb_decoder"]))
    if "batch_stats" in tree:  # rgb_decoder_norm="batch": the running averages
        sd.update(batch_stats_from_flax("rgb_decoder", tree["batch_stats"]["rgb_decoder"]))
    sd.update(mlp_from_flax("lidar_decoder", p["lidar_decoder"]))
    for name, value in p.get("camera_optimizer", {}).items():
        sd[f"camera_optimizer.{name}"] = _t(value)
    return sd


def vgg_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params of `neurad_tpu.model_components.perceptual.Vgg19Slices`
    (`conv_0` .. `conv_12`, HWIO kernels) -> state dict of the port's
    `Vgg19Slices`."""
    p = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted((k for k in p if k.startswith("conv_")), key=lambda k: int(k.split("_")[1])):
        sd.update(_conv(name, p[name]))
    return sd


def splatfacto_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params of `neurad_tpu.models.splatfacto.SplatfactoModel` (or a tree
    shaped like them: gradients, Adam moments) -> state dict of the port's
    SplatfactoModel: the same six arrays under the same names."""
    p = tree["params"] if "params" in tree else tree
    return {name: _t(p[name]) for name in ("means", "scales", "quats", "sh_dc", "sh_rest", "opacities")}


def _hash_encoding(prefix: str, p: Mapping, like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """flax params of a `HashEncoding` (one 1-D leaf a level) -> the port's
    per-level tables, in the physical shapes of `like`."""
    return {f"{prefix}.hash_table.{i}": _t(leaf).reshape(like[f"{prefix}.hash_table.{i}"].shape)
            for i, leaf in enumerate(p["hash_table"])}


def nerfacto_params_from_flax(tree: Mapping, like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """flax params of `neurad_tpu.models.nerfacto.NerfactoModel` (or a tree
    shaped like them: gradients, Adam moments) -> state dict of the port's
    NerfactoModel. `like` is the target model's own state dict: it gives the
    tables' 2-D shapes."""
    p = tree["params"] if "params" in tree else tree
    field = p["field"]
    sd = _hash_encoding("field.encoding", field["encoding"], like)
    sd.update(mlp_from_flax("field.mlp_base", field["mlp_base"]))
    sd.update(mlp_from_flax("field.mlp_head", field["mlp_head"]))
    if "appearance_embedding" in field:
        sd["field.appearance_embedding.weight"] = _t(field["appearance_embedding"]["embedding"])
    for name in ("proposal_0", "proposal_1"):
        prop = p[name]
        sd.update(_hash_encoding(f"{name}.encoding", prop["encoding"], like))
        head = prop["head"]
        sd.update(_dense(f"{name}.head", head) if "kernel" in head else mlp_from_flax(f"{name}.head", head))
    for name, value in p.get("camera_optimizer", {}).items():
        sd[f"camera_optimizer.{name}"] = _t(value)
    return sd


def extra_encoding_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params of one of `neurad_tpu.fields.extra_encodings`' tensor
    decompositions (TensorCP, TensorVM, Triplane, KPlanes) -> the state dict
    of the port's module: the coefficients under the same names."""
    p = tree["params"] if "params" in tree else tree
    return {name: _t(p[name]) for name in ("line_coef", "plane_coef") if name in p}
