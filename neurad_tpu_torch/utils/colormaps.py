"""Colormaps for visualization (depth, scalar fields): the port's copy of
`neurad_tpu/utils/colormaps.py` (numpy; the same anchors), counterpart of
`nerfstudio/utils/colormaps.py` (apply_colormap, apply_depth_colormap).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# turbo-like anchor colors for a perceptually-reasonable default colormap
_TURBO_ANCHORS = np.array(
    [
        [0.19, 0.07, 0.23],
        [0.28, 0.27, 0.90],
        [0.15, 0.70, 0.93],
        [0.10, 0.90, 0.50],
        [0.70, 0.95, 0.15],
        [0.98, 0.73, 0.13],
        [0.95, 0.30, 0.10],
        [0.73, 0.05, 0.05],
    ]
)


def apply_colormap(values: np.ndarray) -> np.ndarray:
    """Scalar [..., 1] in [0,1] -> rgb [..., 3] via piecewise-linear turbo."""
    v = np.clip(np.asarray(values)[..., 0], 0.0, 1.0)
    n = len(_TURBO_ANCHORS) - 1
    idx = np.clip((v * n).astype(np.int32), 0, n - 1)
    frac = v * n - idx
    lo = _TURBO_ANCHORS[idx]
    hi = _TURBO_ANCHORS[idx + 1]
    return lo + (hi - lo) * frac[..., None]


def apply_depth_colormap(
    depth: np.ndarray,
    accumulation: Optional[np.ndarray] = None,
    near_plane: Optional[float] = None,
    far_plane: Optional[float] = None,
) -> np.ndarray:
    """Depth [..., 1] -> rgb, normalized to [near, far] (reference semantics)."""
    d = np.asarray(depth)[..., 0]
    near = near_plane if near_plane is not None else float(np.nanmin(d))
    far = far_plane if far_plane is not None else float(np.nanpercentile(d, 98))
    v = np.clip((d - near) / max(far - near, 1e-8), 0.0, 1.0)
    rgb = apply_colormap(v[..., None])
    if accumulation is not None:
        rgb = rgb * np.asarray(accumulation)
    return rgb
