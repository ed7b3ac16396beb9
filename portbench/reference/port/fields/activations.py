"""Field activations (torch port of `neurad_tpu/fields/activations.py`)."""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    """exp with a clamped-input backward: forward exp(x), backward
    grad * exp(clamp(x, -15, 15)), which keeps density heads from blowing up."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return grad * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
