"""Residual conv block and NeuRAD's patch RGB decoder (torch port of
`neurad_tpu/model_components/cnns.py`).

Public tensors stay NHWC like the JAX module; the convs run NCHW inside.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _make_norm(norm: str, dim: int) -> nn.Module:
    if norm == "group":
        return nn.GroupNorm(8, dim, eps=1e-6)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unsupported norm {norm!r} (batch norm waits for the training slice)")


class BasicBlock(nn.Module):
    """Basic residual block: conv-norm-relu-conv-norm + skip (a 1x1 conv on the
    skip when the channel count changes).

    Convs compute in `compute_dtype` (bf16 by default) with fp32 parameters;
    norms and the output are fp32, as in the JAX block."""

    def __init__(
        self, in_dim: int, dim: int, kernel_size: int = 7, norm: str = "group", compute_dtype=torch.bfloat16
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.res = nn.Conv2d(in_dim, dim, 1) if in_dim != dim else None
        self.conv1 = nn.Conv2d(in_dim, dim, kernel_size, padding="same")
        self.norm1 = _make_norm(norm, dim)
        self.conv2 = nn.Conv2d(dim, dim, kernel_size, padding="same")
        self.norm2 = _make_norm(norm, dim)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, dim] fp32."""
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        res = x if self.res is None else self._conv(self.res, x)
        h = self.norm1(self._conv(self.conv1, x).float()).to(dt)
        h = torch.relu(h)
        h = self.norm2(self._conv(self.conv2, h).float()).to(dt)
        return torch.relu(res + h).float().permute(0, 2, 3, 1)


class RGBDecoderCNN(nn.Module):
    """NeuRAD's patch RGB decoder: 1x1 conv -> 2 x BasicBlock(k7) ->
    ConvTranspose(stride = upsample) -> 2 x BasicBlock(k7) -> 1x1 conv ->
    sigmoid. Input [B, H, W, C_feat + appearance]; output [B, H*up, W*up, 3].

    The blocks and the convs around them compute in `compute_dtype` (bf16 by
    default, None = fp32 end to end); the 3-channel head is always fp32: a bf16
    head and sigmoid would quantise RGB to about 2^-9."""

    def __init__(self, in_dim: int, hidden_dim: int = 32, upsample_factor: int = 3, norm: str = "group",
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype or torch.float32
        dt, up = self.compute_dtype, upsample_factor
        self.stem = nn.Conv2d(in_dim, hidden_dim, 1)
        self.blocks = nn.ModuleList(BasicBlock(hidden_dim, hidden_dim, 7, norm, compute_dtype=dt) for _ in range(4))
        self.upsample = nn.ConvTranspose2d(hidden_dim, hidden_dim, up, stride=up)
        self.head = nn.Conv2d(hidden_dim, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = x.to(dt).permute(0, 3, 1, 2)
        h = torch.relu(F.conv2d(h, self.stem.weight.to(dt), self.stem.bias.to(dt)))
        h = h.permute(0, 2, 3, 1)  # the blocks take and return NHWC fp32
        h = self.blocks[1](self.blocks[0](h))
        h = F.conv_transpose2d(h.to(dt).permute(0, 3, 1, 2), self.upsample.weight.to(dt), self.upsample.bias.to(dt),
                               stride=self.upsample.stride)
        h = self.blocks[3](self.blocks[2](h.permute(0, 2, 3, 1)))
        out = torch.sigmoid(self.head(h.float().permute(0, 3, 1, 2)))
        return out.permute(0, 2, 3, 1)
