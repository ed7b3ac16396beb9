"""More encodings: the Fourier-feature family and the tensor decompositions
(torch port of `neurad_tpu/fields/extra_encodings.py`; nerfstudio's
FFEncoding, RFFEncoding, PolyhedronFFEncoding, TensorCPEncoding,
TensorVMEncoding, TriplaneEncoding and KPlanesEncoding).

`grid_sample` is an explicit bilinear (and linear) gather with
align_corners=True semantics, the JAX package's `_bilinear_sample_2d`: the
corner indices are clipped to the grid, and the fractions measured from the
clipped lower corner and clipped to [0, 1], so that a coordinate beyond the
grid takes the border value. The decompositions' coefficients are parameters
of the same names and shapes as the flax modules' (`extra_encoding_params_from_flax`
carries them); the sampling coordinates carry no gradient, as in the JAX
package.
"""

from __future__ import annotations

import math
from itertools import combinations
from typing import Optional

import numpy as np
import torch
from torch import nn

from neurad_tpu_torch.core.math_utils import expected_sin


def _bilinear_sample_2d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [C, H, W], coords [N, 2] in [-1, 1] (x, y), align_corners=True -> [N, C]."""
    h, w = grid.shape[1], grid.shape[2]
    x = (coords[:, 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x).to(torch.int64).clamp(0, w - 1)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    g = lambda yy, xx: grid[:, yy, xx]  # [C, N]
    out = (g(y0, x0) * ((1 - fx) * (1 - fy)) + g(y0, x1) * (fx * (1 - fy))
           + g(y1, x0) * ((1 - fx) * fy) + g(y1, x1) * (fx * fy))
    return out.T


def _linear_sample_1d(line: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """line [C, R], coords [N] in [-1, 1] -> [N, C]."""
    r = line.shape[1]
    x = (coords + 1.0) * 0.5 * (r - 1)
    x0 = torch.floor(x).to(torch.int64).clamp(0, r - 1)
    x1 = (x0 + 1).clamp(0, r - 1)
    fx = (x - x0).clamp(0.0, 1.0)
    return (line[:, x0] * (1 - fx) + line[:, x1] * fx).T


class FFEncoding(nn.Module):
    """Fourier features over a fixed basis [in_dim, M], with mip-NeRF's
    integration over a covariance when one is given."""

    def __init__(self, basis, num_frequencies: int = 10, min_freq_exp: float = 0.0, max_freq_exp: float = 8.0,
                 include_input: bool = False):
        super().__init__()
        self.register_buffer("basis", torch.as_tensor(np.asarray(basis, np.float32)), persistent=False)
        self.num_frequencies, self.min_freq_exp, self.max_freq_exp = num_frequencies, min_freq_exp, max_freq_exp
        self.include_input = include_input

    @property
    def out_dim(self) -> int:
        return self.basis.shape[1] * self.num_frequencies * 2 + (self.basis.shape[0] if self.include_input else 0)

    def forward(self, in_tensor: torch.Tensor, covs: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = self.basis.to(in_tensor.device)
        scaled = 2.0 * math.pi * in_tensor @ b  # [..., M]
        freqs = 2.0 ** torch.linspace(self.min_freq_exp, self.max_freq_exp, self.num_frequencies,
                                      device=in_tensor.device)
        scaled = (scaled[..., None] * freqs).reshape(in_tensor.shape[:-1] + (-1,))
        both = torch.cat([scaled, scaled + math.pi / 2.0], dim=-1)
        if covs is None:
            out = torch.sin(both)
        else:
            var = torch.sum((covs @ b) * b, dim=-2)
            var = (var[..., :, None] * freqs**2).reshape(in_tensor.shape[:-1] + (-1,))
            out = expected_sin(both, torch.cat([var, var], dim=-1))
        if self.include_input:
            out = torch.cat([out, in_tensor], dim=-1)
        return out


def rff_basis(in_dim: int, num_frequencies: int, scale: float, seed: int = 0) -> tuple:
    """A random Fourier basis [in_dim, num_frequencies] from numpy's generator."""
    rng = np.random.default_rng(seed)
    return tuple(map(tuple, (rng.normal(0, scale, (in_dim, num_frequencies))).tolist()))


def octahedron_basis() -> tuple:
    """The octahedron's vertex directions as a basis (PolyhedronFFEncoding)."""
    return tuple(map(tuple, np.eye(3).T.tolist()))


def _normal(shape, init_scale: float, generator: Optional[torch.Generator], offset: float = 0.0) -> nn.Parameter:
    return nn.Parameter(init_scale * torch.randn(shape, generator=generator) + offset)


class TensorCPEncoding(nn.Module):
    """TensoRF's CP decomposition: a product of three line samples."""

    def __init__(self, resolution: int = 256, num_components: int = 24, init_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_components = num_components
        self.line_coef = _normal((3, num_components, resolution), init_scale, generator)

    @property
    def out_dim(self) -> int:
        return self.num_components

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        shape = in_tensor.shape[:-1]
        x = in_tensor.reshape(-1, 3).detach()
        feats = None
        for axis in range(3):
            f = _linear_sample_1d(self.line_coef[axis], x[:, 2 - axis])
            feats = f if feats is None else feats * f
        return feats.reshape(shape + (self.num_components,))


class TensorVMEncoding(nn.Module):
    """TensoRF's vector-matrix decomposition: per axis a plane sample times a line sample."""

    def __init__(self, resolution: int = 128, num_components: int = 24, init_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_components = num_components
        self.plane_coef = _normal((3, num_components, resolution, resolution), init_scale, generator)
        self.line_coef = _normal((3, num_components, resolution), init_scale, generator)

    @property
    def out_dim(self) -> int:
        return self.num_components * 3

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        shape = in_tensor.shape[:-1]
        x = in_tensor.reshape(-1, 3).detach()
        outs = []
        for i, (a, b) in enumerate(((0, 1), (0, 2), (1, 2))):
            pf = _bilinear_sample_2d(self.plane_coef[i], x[:, (a, b)])
            lf = _linear_sample_1d(self.line_coef[i], x[:, 2 - i])
            outs.append(pf * lf)
        return torch.cat(outs, dim=-1).reshape(shape + (self.out_dim,))


class TriplaneEncoding(nn.Module):
    """Three axis-aligned feature planes, summed (or multiplied)."""

    def __init__(self, resolution: int = 32, num_components: int = 64, init_scale: float = 0.1,
                 reduce: str = "sum", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_components, self.reduce = num_components, reduce
        self.plane_coef = _normal((3, num_components, resolution, resolution), init_scale, generator)

    @property
    def out_dim(self) -> int:
        return self.num_components

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        shape = in_tensor.shape[:-1]
        x = in_tensor.reshape(-1, 3).detach()
        outs = [_bilinear_sample_2d(self.plane_coef[0], x[:, (0, 1)]),
                _bilinear_sample_2d(self.plane_coef[1], x[:, (0, 2)]),
                _bilinear_sample_2d(self.plane_coef[2], x[:, (1, 2)])]
        out = outs[0]
        for o in outs[1:]:
            out = out * o if self.reduce == "product" else out + o
        return out.reshape(shape + (self.num_components,))


class KPlanesEncoding(nn.Module):
    """K-Planes over d-dimensional inputs: one plane per pair of coordinates,
    the samples multiplied (or summed); product planes start around 1."""

    def __init__(self, in_dim: int = 4, resolution: int = 64, num_components: int = 32, init_scale: float = 0.1,
                 reduce: str = "product", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.num_components, self.reduce = in_dim, num_components, reduce
        self.pairs = list(combinations(range(in_dim), 2))
        self.plane_coef = _normal((len(self.pairs), num_components, resolution, resolution), init_scale, generator,
                                  offset=1.0 if reduce == "product" else 0.0)

    @property
    def out_dim(self) -> int:
        return self.num_components

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        shape = in_tensor.shape[:-1]
        x = in_tensor.reshape(-1, self.in_dim).detach()
        out = None
        for i, (a, b) in enumerate(self.pairs):
            f = _bilinear_sample_2d(self.plane_coef[i], x[:, (a, b)])
            out = f if out is None else (out * f if self.reduce == "product" else out + f)
        return out.reshape(shape + (self.num_components,))
