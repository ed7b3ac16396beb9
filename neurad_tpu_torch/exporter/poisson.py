"""Poisson surface reconstruction from an oriented point cloud: the port's
copy of `neurad_tpu/exporter/poisson.py` (host numpy).

Self-contained counterpart of the reference's `ns-export poisson`
(`nerfstudio/scripts/exporter.py:261-380`), which delegates to open3d's
screened-Poisson (not in this image). Classic Kazhdan-style pipeline on a
regular grid:

  1. splat oriented normals into a vector field V (trilinear),
  2. optionally smooth V with a gaussian (spectral multiply),
  3. solve the Poisson equation  laplacian(chi) = div(V)  with an FFT
     (periodic boundary; the aabb is padded so wraparound is negligible),
  4. iso-extract at the mean indicator value sampled at the input points.

Host-side numpy: export runs once per checkpoint, and an FFT on a 256-cube is
milliseconds — no kernel needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _trilinear_splat(grid: np.ndarray, idx_f: np.ndarray, values: np.ndarray) -> None:
    """Scatter-add `values` [N, C] at fractional indices [N, 3] into grid [r,r,r,C]."""
    r = grid.shape[0]
    base = np.floor(idx_f).astype(np.int64)
    frac = idx_f - base
    for corner in range(8):
        off = np.array([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1])
        w = np.prod(np.where(off[None, :] == 1, frac, 1.0 - frac), axis=-1)
        ijk = np.clip(base + off[None, :], 0, r - 1)
        np.add.at(grid, (ijk[:, 0], ijk[:, 1], ijk[:, 2]), values * w[:, None])


def _trilinear_sample(vol: np.ndarray, idx_f: np.ndarray) -> np.ndarray:
    """Sample vol [r,r,r] at fractional indices [N, 3]."""
    r = vol.shape[0]
    base = np.floor(idx_f).astype(np.int64)
    frac = idx_f - base
    out = np.zeros(idx_f.shape[0])
    for corner in range(8):
        off = np.array([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1])
        w = np.prod(np.where(off[None, :] == 1, frac, 1.0 - frac), axis=-1)
        ijk = np.clip(base + off[None, :], 0, r - 1)
        out += vol[ijk[:, 0], ijk[:, 1], ijk[:, 2]] * w
    return out


def poisson_reconstruct(
    points: np.ndarray,
    normals: np.ndarray,
    resolution: int = 128,
    aabb: Optional[np.ndarray] = None,
    pad_frac: float = 0.15,
    smooth_sigma: float = 1.5,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Solve for the (smoothed) indicator function chi of the surface.

    points [N,3], normals [N,3] OUTWARD unit normals. Returns (chi [r,r,r],
    iso value, aabb [2,3]) — the surface is the `chi == iso` level set, with
    chi > iso inside. Feed `(-chi, -iso)` to `marching_tetrahedra` (which
    treats vals < iso as inside).
    """
    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    if aabb is None:
        lo, hi = points.min(axis=0), points.max(axis=0)
        pad = (hi - lo).max() * pad_frac + 1e-6
        aabb = np.stack([lo - pad, hi + pad])
    else:
        aabb = np.asarray(aabb, np.float64)
    r = resolution
    scale = (r - 1) / (aabb[1] - aabb[0])
    idx_f = (points - aabb[0]) * scale

    # 1. vector field V = -outward normal (so grad(chi) ~ V and chi is HIGH inside)
    V = np.zeros((r, r, r, 3))
    _trilinear_splat(V, idx_f, -normals)

    # 2+3. spectral: smooth, divergence, inverse laplacian — all per-axis factors
    k = np.fft.fftfreq(r)  # cycles per voxel
    h = (aabb[1] - aabb[0]) / (r - 1)  # voxel size per axis
    Vh = [np.fft.fftn(V[..., a]) for a in range(3)]
    if smooth_sigma > 0:
        # gaussian in voxel units, separable in frequency space
        g1 = [np.exp(-2 * (np.pi * k * smooth_sigma) ** 2) for _ in range(3)]
        sm = g1[0][:, None, None] * g1[1][None, :, None] * g1[2][None, None, :]
        Vh = [vh * sm for vh in Vh]
    # spectral derivative i*2pi*k/h per axis; laplacian eigenvalues -(2pi k/h)^2
    kx = 2j * np.pi * k
    div_h = (
        Vh[0] * (kx / h[0])[:, None, None]
        + Vh[1] * (kx / h[1])[None, :, None]
        + Vh[2] * (kx / h[2])[None, None, :]
    )
    lap = (
        -((2 * np.pi * k / h[0]) ** 2)[:, None, None]
        - ((2 * np.pi * k / h[1]) ** 2)[None, :, None]
        - ((2 * np.pi * k / h[2]) ** 2)[None, None, :]
    )
    lap[0, 0, 0] = 1.0  # DC is arbitrary (indicator defined up to a constant)
    chi_h = div_h / lap
    chi_h[0, 0, 0] = 0.0
    chi = np.real(np.fft.ifftn(chi_h))

    # 4. iso value = mean indicator at the input samples (Kazhdan's rule)
    iso = float(np.mean(_trilinear_sample(chi, idx_f)))
    return chi.astype(np.float32), iso, aabb.astype(np.float32)


def normals_from_depth(
    positions: np.ndarray, cam_center: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel outward normals from an [H,W,3] world-position map.

    Cross product of the image-space position gradients, oriented toward the
    camera (the visible side) — the reference's `normal_method="open3d"`
    estimates the same from the projected point cloud. Returns (normals
    [H,W,3], valid [H,W])."""
    dx = np.gradient(positions, axis=1)
    dy = np.gradient(positions, axis=0)
    n = np.cross(dx, dy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    valid = norm[..., 0] > 1e-9
    n = n / np.maximum(norm, 1e-9)
    to_cam = cam_center[None, None, :] - positions
    flip = np.sum(n * to_cam, axis=-1, keepdims=True) < 0
    return np.where(flip, -n, n), valid
