"""Splatfacto: static 3D gaussian splatting with spherical-harmonics colours
(torch port of `neurad_tpu/models/splatfacto.py`).

Each gaussian's SH coefficients are evaluated at its direction from the camera
centre, and the colours go through the same tile rasterizer as SplatAD's
features (`ops/gaussian_rasterize.rasterize_camera`: the camera tile
composite and, under autograd, its fused backward, C = 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from neurad_tpu_torch.model_components import losses as L
from neurad_tpu_torch.models.splatad import viewmat_from_c2w_opengl
from neurad_tpu_torch.ops import gaussian_rasterize as GR
from neurad_tpu_torch.ops import gaussians as G
from neurad_tpu_torch.ops.spherical_harmonics import components_from_spherical_harmonics

PARAM_KEYS = ("means", "scales", "quats", "sh_dc", "sh_rest", "opacities")


@dataclasses.dataclass(frozen=True)
class SplatfactoConfig:
    sh_degree: int = 3
    tile_size: int = 16
    max_per_tile: int = 256
    max_tiles_per_gaussian: int = 16
    near_plane: float = 0.2
    eps2d: float = 0.3
    ssim_lambda: float = 0.2
    background_color: Tuple[float, float, float] = (0.1490, 0.1647, 0.2157)


def random_init_gaussians(num_points: int, extent: float = 10.0, seed: int = 0, sh_degree: int = 3):
    """Random gaussians in a cube of side `extent` (numpy, seeded): the same
    arrays as the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    n_sh = (sh_degree + 1) ** 2
    quats = np.zeros((num_points, 4), dtype=np.float32)
    quats[:, 0] = 1.0
    return {
        "means": (rng.uniform(-0.5, 0.5, (num_points, 3)) * extent).astype(np.float32),
        "scales": np.full((num_points, 3), np.log(extent / num_points ** (1 / 3)), dtype=np.float32),
        "quats": quats,
        "sh_dc": rng.normal(0, 0.1, (num_points, 3)).astype(np.float32),
        "sh_rest": np.zeros((num_points, (n_sh - 1) * 3), dtype=np.float32),
        "opacities": np.full((num_points,), np.log(0.1 / 0.9), dtype=np.float32),
    }


class SplatfactoModel(nn.Module):
    """Static 3DGS: the gaussians' parameters (`PARAM_KEYS`) and the render."""

    def __init__(self, init_params: Dict[str, np.ndarray], config: SplatfactoConfig = SplatfactoConfig()):
        super().__init__()
        self.config = config
        for k in PARAM_KEYS:
            setattr(self, k, nn.Parameter(torch.as_tensor(np.asarray(init_params[k], dtype=np.float32))))

    def _sh_colors(self, camera_pos: torch.Tensor) -> torch.Tensor:
        """RGB of each gaussian: its SH evaluated at the unit direction from the
        camera centre, + 0.5, clipped to [0, 1]."""
        dirs = self.means - camera_pos
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-8)
        levels = self.config.sh_degree + 1
        basis = components_from_spherical_harmonics(levels, dirs)  # [N, L^2]
        coeffs = torch.cat([self.sh_dc, self.sh_rest], dim=-1).reshape(-1, levels**2, 3)
        rgb = torch.einsum("nk,nkc->nc", basis, coeffs)
        return (rgb + 0.5).clamp(0.0, 1.0)

    def render(
        self, c2w_opengl, K, width: int, height: int, means2d_offset: Optional[torch.Tensor] = None
    ) -> Dict[str, torch.Tensor]:
        """OpenGL camera-to-world [3|4, 4] and intrinsics [3, 3] -> rgb [H, W, 3]
        over the background colour, depth, accumulation and the radii.
        `means2d_offset`: zeros [N, 2] whose gradient is d(loss)/d(means2d), the
        Default strategy's absgrad signal."""
        cfg = self.config
        dev = self.means.device
        c2w = torch.as_tensor(c2w_opengl, dtype=torch.float32, device=dev)
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        covar6 = G.quat_scale_to_covar6(self.quats, torch.exp(self.scales))
        proj = G.project_gaussians_camera(
            self.means, covar6=covar6, viewmat=viewmat_from_c2w_opengl(c2w), K=K, width=width, height=height,
            near_plane=cfg.near_plane, eps2d=cfg.eps2d,
        )
        if means2d_offset is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_offset)
        rgb, depth, alpha = GR.rasterize_camera(
            proj,
            self._sh_colors(c2w[:3, 3]),
            torch.sigmoid(self.opacities),
            width,
            height,
            tile_size=cfg.tile_size,
            max_per_tile=cfg.max_per_tile,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        )
        bg = rgb.new_tensor(cfg.background_color)
        rgb = (rgb + (1.0 - alpha) * bg).clamp(0.0, 1.0)
        return {"rgb": rgb, "depth": depth, "accumulation": alpha, "radii": proj.radii.detach()}

    def forward(self, c2w, K, width: int, height: int) -> Dict[str, torch.Tensor]:
        return self.render(c2w, K, width, height)

    def loss(self, outputs: Dict[str, torch.Tensor], gt_image: torch.Tensor):
        """(1 - ssim_lambda) L1 + ssim_lambda (1 - SSIM) -> (total, metrics)."""
        cfg = self.config
        l1 = torch.mean(torch.abs(outputs["rgb"] - gt_image))
        ssim_val = L.ssim(outputs["rgb"], gt_image)
        total = (1 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * (1 - ssim_val)
        return total, {
            "main_loss": total,
            "psnr": L.psnr(outputs["rgb"].detach(), gt_image),
            "ssim": ssim_val.detach(),
        }
