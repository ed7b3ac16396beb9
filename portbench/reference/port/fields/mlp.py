"""MLP (torch port of `neurad_tpu/fields/mlp.py`).

Layers are named `hidden_{i}` and `output` like the flax module, so the
parameter bridge maps names one to one. Computes in `compute_dtype` (bf16 by
default, None for fp32) with fp32 parameters and fp32 outputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.port.precision import cast


class MLP(nn.Module):
    """ReLU multi-layer perceptron. num_layers counts Linear layers
    (num_layers=2 means one hidden layer). `skip_connections`: hidden layer i
    (i > 0) takes the MLP's input concatenated to its own. `out_activation`
    is applied to the fp32 output (None: raw outputs)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        num_layers: int = 2,
        layer_width: int = 64,
        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
        skip_connections: Sequence[int] = (),
        out_activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.skips = frozenset(i for i in skip_connections if i > 0)
        self.out_activation = out_activation
        width = in_dim
        for i in range(num_layers - 1):
            if i in self.skips:
                width += in_dim
            setattr(self, f"hidden_{i}", nn.Linear(width, layer_width))
            width = layer_width
        self.output = nn.Linear(width, out_dim)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return layer(x)
        return F.linear(cast(x, dt), cast(layer.weight, dt), cast(layer.bias, dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.compute_dtype is None else cast(x, self.compute_dtype)
        inp = h if self.skips else None  # held only where a layer takes it again
        for i in range(self.num_layers - 1):
            if i in self.skips:
                h = torch.cat([h, inp], dim=-1)
            h = torch.relu(self._linear(getattr(self, f"hidden_{i}"), h))
        out = self._linear(self.output, h).float()
        return out if self.out_activation is None else self.out_activation(out)
