"""MLP (torch port of `neurad_tpu/fields/mlp.py`).

Layers are named `hidden_{i}` and `output` like the flax module, so the
parameter bridge maps names one to one. Computes in `compute_dtype` (bf16 by
default, None for fp32) with fp32 parameters and fp32 outputs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Module):
    """ReLU multi-layer perceptron with raw outputs. num_layers counts Linear
    layers (num_layers=2 means one hidden layer). The JAX module's skip
    connections and output activation are not ported: no ported model uses
    them."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        num_layers: int = 2,
        layer_width: int = 64,
        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        width = in_dim
        for i in range(num_layers - 1):
            setattr(self, f"hidden_{i}", nn.Linear(width, layer_width))
            width = layer_width
        self.output = nn.Linear(width, out_dim)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return layer(x)
        return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.compute_dtype is None else x.to(self.compute_dtype)
        for i in range(self.num_layers - 1):
            h = torch.relu(self._linear(getattr(self, f"hidden_{i}"), h))
        return self._linear(self.output, h).float()
