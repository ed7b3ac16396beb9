"""Host-side lidar binning for the dataparsers' missing-point synthesis.

The port's own version of `neurad_tpu.native.bin_points` (a C++ host routine,
`neurad_tpu/native/patchops.cpp`, with a numpy fallback): numpy in float32,
in the C++ loop's order of operations. It is data preparation on the host,
not a device kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_RAD2DEG = np.float32(57.29577951308232)


def bin_points(
    points: np.ndarray, elevations: np.ndarray, azim_res_deg: float, n_azim: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sensor-frame xyz [N, >=3] -> (occupied [C, A] bool, channel [N],
    azimuth bin [N]): each point's channel is the one of nearest elevation
    (the first on a tie), its bin (atan2(y, x) in degrees + 180) / resolution,
    truncated and clipped to [0, n_azim)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    elevs = np.ascontiguousarray(elevations, np.float32)
    r2d = np.sqrt(x * x + y * y)
    elev = _RAD2DEG * np.arctan2(z, np.maximum(r2d, np.float32(1e-9)))
    ch = np.abs(elev[:, None] - elevs[None, :]).argmin(-1).astype(np.int64)
    azim = _RAD2DEG * np.arctan2(y, x)
    ab = ((azim + np.float32(180.0)) / np.float32(azim_res_deg)).astype(np.int64)
    ab = np.clip(ab, 0, n_azim - 1)
    occ = np.zeros((len(elevs), n_azim), dtype=bool)
    occ[ch, ab] = True
    return occ, ch, ab
