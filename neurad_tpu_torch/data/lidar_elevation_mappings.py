"""Per-sensor lidar channel -> elevation tables (degrees), and each sensor's
azimuth resolution at 10 Hz.

The port's own copy of `neurad_tpu/data/lidar_elevation_mappings.py` (numpy
only; the port imports nothing of the JAX package). The measured tables are
hardware calibration facts (diode index -> beam elevation); uniform-spacing
sensors use their published spec formulas.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# Hesai Pandar64 measured beam table (diode order), `lidar_elevation_mappings.py:19-84`
PANDAR64_ELEVATIONS = np.array(
    [
        14.882, 11.032, 8.059, 5.057, 3.04, 2.028, 1.86, 1.688,
        1.522, 1.351, 1.184, 1.013, 0.846, 0.675, 0.508, 0.337,
        0.169, 0, -0.169, -0.337, -0.508, -0.675, -0.846, -1.013,
        -1.184, -1.351, -1.522, -1.688, -1.86, -2.028, -2.198, -2.365,
        -2.536, -2.7, -2.873, -3.04, -3.21, -3.375, -3.548, -3.712,
        -3.884, -4.05, -4.221, -4.385, -4.558, -4.72, -4.892, -5.057,
        -5.229, -5.391, -5.565, -5.726, -5.898, -6.061, -7.063, -8.059,
        -9.06, -9.885, -11.032, -12.006, -12.974, -13.93, -18.889, -24.897,
    ],
    dtype=np.float32,
)

# Velodyne VLS-128 (Alpha Prime) measured beam table, `lidar_elevation_mappings.py:86-215`
VELODYNE128_ELEVATIONS = np.array(
    [
        -11.742, -1.99, 3.4, -5.29, -0.78, 4.61, -4.08, 1.31,
        -6.5, -1.11, 4.28, -4.41, 0.1, 6.48, -3.2, 2.19,
        -3.86, 1.53, -9.244, -1.77, 2.74, -5.95, -0.56, 4.83,
        -2.98, 2.41, -6.28, -0.89, 3.62, -5.07, 0.32, 7.58,
        -0.34, 5.18, -3.64, 1.75, -25, -2.43, 2.96, -5.73,
        0.54, 9.7, -2.76, 2.63, -7.65, -1.55, 3.84, -4.85,
        3.18, -5.51, -0.12, 5.73, -4.3, 1.09, -16.042, -2.21,
        4.06, -4.63, 0.76, 15, -3.42, 1.97, -6.85, -1.33,
        -5.62, -0.23, 5.43, -3.53, 0.98, -19.582, -2.32, 3.07,
        -4.74, 0.65, 11.75, -2.65, 1.86, -7.15, -1.44, 3.95,
        -2.1, 3.29, -5.4, -0.01, 4.5, -4.19, 1.2, -13.565,
        -1.22, 4.17, -4.52, 0.87, 6.08, -3.31, 2.08, -6.65,
        1.42, -10.346, -1.88, 3.51, -6.06, -0.67, 4.72, -3.97,
        2.3, -6.39, -1, 4.39, -5.18, 0.21, 6.98, -3.09,
        4.98, -3.75, 1.64, -8.352, -2.54, 2.85, -5.84, -0.45,
        8.43, -2.87, 2.52, -6.17, -1.66, 3.73, -4.96, 0.43,
    ],
    dtype=np.float32,
)

# Velodyne VLP-32C factory beam table, `lidar_elevation_mappings.py:217-250`
VELODYNE_VLP32C_ELEVATIONS = np.array(
    [
        -25, -1, -1.667, -15.639, -11.31, 0, -0.667, -8.843,
        -7.254, 0.333, -0.333, -6.148, -5.333, 1.333, 0.667, -4,
        -4.667, 1.667, 1, -3.667, -3.333, 3.333, 2.333, -2.667,
        -3, 7, 4.667, -2.333, -2, 15, 10.333, -1.333,
    ],
    dtype=np.float32,
)

# Argoverse2's VLP-32C mounting-order variant, `lidar_elevation_mappings.py:252-285`
ARGOVERSE2_VLP32C_ELEVATIONS = np.array(
    [
        7, -1.667, 1.667, -0.667, 15, -0.333, 3.333, 0.667,
        1.333, 0, 1, 2.333, 0.333, -1, 4.667, 10.333,
        -6.148, -15.639, -3, -2, -4, -8.843, -4.667, -3.333,
        -2.667, -5.333, -1.333, -7.254, -3.667, -11.31, -2.333, -25,
    ],
    dtype=np.float32,
)

# Waymo Open Dataset top lidar measured inclinations, `lidar_elevation_mappings.py:289-354`
WOD64_ELEVATIONS = np.array(
    [
        2.50284, 2.32141, 2.16019, 1.98884, 1.82093, 1.65024, 1.49387, 1.32216,
        1.16325, 0.991375, 0.81015, 0.648204, 0.48337, 0.320159, 0.164623, -0.0116219,
        -0.189279, -0.342011, -0.505447, -0.682762, -0.844979, -1.01975, -1.18863, -1.36694,
        -1.54093, -1.75706, -1.96494, -2.18944, -2.43745, -2.6684, -2.92548, -3.20879,
        -3.46524, -3.77065, -4.06805, -4.36556, -4.68136, -5.0239, -5.36084, -5.7155,
        -6.09111, -6.45727, -6.84515, -7.24803, -7.64553, -8.08179, -8.5225, -8.95725,
        -9.42147, -9.88527, -10.3691, -10.8297, -11.3322, -11.8229, -12.3644, -12.9086,
        -13.4378, -13.9838, -14.5375, -15.0764, -15.6893, -16.3003, -16.9119, -17.5468,
    ],
    dtype=np.float32,
)


def velodyne16_elevations() -> np.ndarray:
    """VLP-16: 16 channels, -15..+15 deg in 2 deg steps (spec formula)."""
    return np.array([-15 + 2 * i for i in range(16)], dtype=np.float32)


def velodyne_hdl32e_elevations() -> np.ndarray:
    """HDL-32E: 32 channels, -30.67..+10.67 deg, 1.33 deg spacing
    (`lidar_elevation_mappings.py:287` uses the same linspace)."""
    return np.linspace(-30.67, 10.67, 32).astype(np.float32)


def velodyne64e_elevations() -> np.ndarray:
    """HDL-64E: upper block 1/3 deg spacing (+2..-8.33), lower 1/2 deg (-8.83..-24.33)."""
    upper = 2.0 - np.arange(32) / 3.0
    lower = -8.83 - np.arange(32) / 2.0
    return np.concatenate([upper, lower]).astype(np.float32)


ELEVATION_MAPPINGS: Dict[str, np.ndarray] = {
    "VELODYNE16": velodyne16_elevations(),
    "VELODYNE_HDL32E": velodyne_hdl32e_elevations(),
    "VELODYNE64E": velodyne64e_elevations(),
    "VELODYNE128": VELODYNE128_ELEVATIONS,
    "VELODYNE_VLP32C": VELODYNE_VLP32C_ELEVATIONS,
    "ARGOVERSE2_VLP32C": ARGOVERSE2_VLP32C_ELEVATIONS,
    "PANDAR64": PANDAR64_ELEVATIONS,
    "WOD64": WOD64_ELEVATIONS,
}

# Azimuth resolution in degrees at 10 Hz spin (`pandaset_dataparser.py:94`)
AZIMUTH_RESOLUTION: Dict[str, float] = {
    "VELODYNE16": 0.2,
    "VELODYNE_HDL32E": 0.166,
    "VELODYNE64E": 0.1728,
    "VELODYNE128": 0.2,
    "VELODYNE_VLP32C": 0.2,
    "ARGOVERSE2_VLP32C": 0.2,
    "PANDAR64": 0.2,
    "WOD64": 0.1,
}


def assign_channels(points: np.ndarray, elevations: np.ndarray) -> np.ndarray:
    """Nearest-elevation channel index per point (sensor-frame xyz [N, 3])."""
    r2d = np.linalg.norm(points[:, :2], axis=-1)
    elev = np.rad2deg(np.arctan2(points[:, 2], np.clip(r2d, 1e-9, None)))
    return np.abs(elev[:, None] - elevations[None, :]).argmin(-1)
