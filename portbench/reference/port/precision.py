"""Compute precision of the reference's MLPs and convolutions.

`cast(x, dt)` is `x.to(dt)` for a torch dtype. For `FP8` it rounds `x` to
float8 e4m3 under a per-tensor scale (the largest magnitude mapped to 448,
the format's largest value) and returns it in float32, so the product that
follows takes fp8 operands and accumulates in fp32: the control's precision,
one step below the bf16 that the configurations state.
"""

from __future__ import annotations

import torch

FP8 = "fp8"
_E4M3_MAX = 448.0


def cast(x: torch.Tensor, dt) -> torch.Tensor:
    if dt != FP8:
        return x.to(dt)
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def float_of(dt):
    """The dtype a tensor of compute dtype `dt` is held in."""
    return torch.float32 if dt == FP8 else dt
