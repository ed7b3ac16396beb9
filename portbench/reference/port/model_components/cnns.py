"""Residual conv blocks and NeuRAD's patch RGB decoder (torch port of
`neurad_tpu/model_components/cnns.py`).

Public tensors stay NHWC like the JAX module; the convs run NCHW inside.
`norm="batch"` is flax's `nn.BatchNorm(use_running_average=not train)`:
`FlaxBatchNorm` keeps flax's statistics, not `nn.BatchNorm2d`'s (see there).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.port.precision import cast


_BATCH_MEAN: contextvars.ContextVar = contextvars.ContextVar("batch_mean", default=None)


@contextlib.contextmanager
def batch_statistics_over(mean_of_means: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block a batch norm in train mode takes its statistics
    through `mean_of_means` (a data-parallel step's mean over the ranks,
    each rank normalising its share of the global batch by the global
    batch's statistics)."""
    token = _BATCH_MEAN.set(mean_of_means)
    try:
        yield
    finally:
        _BATCH_MEAN.reset(token)


class FlaxBatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over NCHW channels, with its defaults: with
    `train` the batch's mean and its biased variance (flax's fast form,
    max(E[x^2] - E[x]^2, 0)) normalise, and the running averages move as
    `r = 0.99 r + 0.01 batch` (with the biased variance); without it the
    running averages normalise. `nn.BatchNorm2d` would take momentum 0.1 and
    the unbiased variance into its running averages, so the update is written
    out. epsilon 1e-5, a scale and a bias. Under `batch_statistics_over` the
    batch's statistics are a data-parallel world's global batch's."""

    def __init__(self, dim: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean, mean_sq = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            over_ranks = _BATCH_MEAN.get()
            if over_ranks is not None:
                mean, mean_sq = over_ranks(mean), over_ranks(mean_sq)
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean.detach())
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _make_norm(norm: str, dim: int) -> nn.Module:
    if norm == "group":
        return nn.GroupNorm(8, dim, eps=1e-6)
    if norm == "batch":
        return FlaxBatchNorm(dim)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r}; one of group, batch, none")


def _apply_norm(norm: nn.Module, h: torch.Tensor, train: bool) -> torch.Tensor:
    return norm(h, train) if isinstance(norm, FlaxBatchNorm) else norm(h)


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
        return F.conv2d(cast(x, dt), cast(conv.weight, dt), cast(conv.bias, dt), padding=conv.padding)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H, W, dim] fp32. `train`: a batch norm
        normalises by the batch and updates its running averages."""
        dt = self.compute_dtype
        x = cast(x, dt).permute(0, 3, 1, 2)
        res = x if self.res is None else self._conv(self.res, x)
        h = cast(_apply_norm(self.norm1, self._conv(self.conv1, x).float(), train), dt)
        h = torch.relu(h)
        h = cast(_apply_norm(self.norm2, self._conv(self.conv2, h).float(), train), dt)
        return torch.relu(res + h).float().permute(0, 2, 3, 1)


class BottleneckBlock(nn.Module):
    """Bottleneck residual block (`nerfstudio/model_components/cnns.py:49-66`):
    1x1 conv to `channel_multiplier * dim` channels, norm, relu; k x k conv,
    norm, relu; 1x1 conv back to `dim`, norm; plus the skip (a 1x1 conv when
    `in_dim` differs from `dim`), relu. fp32 throughout, as the JAX block is.
    `in_dim` defaults to `dim`."""

    def __init__(self, dim: int, kernel_size: int = 3, channel_multiplier: int = 1, norm: str = "group",
                 in_dim: Optional[int] = None):
        super().__init__()
        in_dim = dim if in_dim is None else in_dim
        mid = channel_multiplier * dim
        self.res = nn.Conv2d(in_dim, dim, 1) if in_dim != dim else None
        self.conv1 = nn.Conv2d(in_dim, mid, 1)
        self.norm1 = _make_norm(norm, mid)
        self.conv2 = nn.Conv2d(mid, mid, kernel_size, padding="same")
        self.norm2 = _make_norm(norm, mid)
        self.conv3 = nn.Conv2d(mid, dim, 1)
        self.norm3 = _make_norm(norm, dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x [B, H, W, in_dim] -> [B, H, W, dim] fp32. `train`: a batch norm
        normalises by the batch and updates its running averages."""
        x = x.float().permute(0, 3, 1, 2)
        res = x if self.res is None else self.res(x)
        h = torch.relu(_apply_norm(self.norm1, self.conv1(x), train))
        h = torch.relu(_apply_norm(self.norm2, self.conv2(h), train))
        h = _apply_norm(self.norm3, self.conv3(h), train)
        return torch.relu(res + h).permute(0, 2, 3, 1)


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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        h = cast(x, dt).permute(0, 3, 1, 2)
        h = torch.relu(F.conv2d(cast(h, dt), cast(self.stem.weight, dt), cast(self.stem.bias, dt)))
        h = h.permute(0, 2, 3, 1)  # the blocks take and return NHWC fp32
        h = self.blocks[1](self.blocks[0](h, train), train)
        h = F.conv_transpose2d(cast(h, dt).permute(0, 3, 1, 2), cast(self.upsample.weight, dt), cast(self.upsample.bias, dt),
                               stride=self.upsample.stride)
        h = self.blocks[3](self.blocks[2](h.permute(0, 2, 3, 1), train), train)
        out = torch.sigmoid(self.head(h.float().permute(0, 3, 1, 2)))
        return out.permute(0, 2, 3, 1)
