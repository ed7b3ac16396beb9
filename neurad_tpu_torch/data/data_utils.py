"""Point-cloud utilities of data loading (the port's own copy of
`neurad_tpu/data/data_utils.py`; nerfstudio's `points_in_box` and
`remove_dynamic_points`): host-side numpy, run when a scene is loaded.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def points_in_box(points: np.ndarray, box2world: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Mask of world-frame points inside an oriented box. points [N, 3];
    box2world [4, 4] (or [3, 4]); size [3], the full extents."""
    rot = box2world[:3, :3]
    t = box2world[:3, 3]
    local = (points[:, :3] - t) @ rot  # rot^T, applied from the right
    half = np.asarray(size, dtype=np.float64) / 2.0
    return np.all(np.abs(local) < half, axis=-1)


def remove_dynamic_points(
    point_clouds: Sequence[np.ndarray],
    l2ws: Sequence[np.ndarray],
    timestamps: Sequence[float],
    trajectories: List[dict],
    extra_padding: float = 0.15,
) -> List[np.ndarray]:
    """Drop the points inside any dynamic actor's box (padded by
    `extra_padding`) at the scan's timestamp. Point clouds are in the sensor
    frame; l2ws are sensor-to-world [3|4, 4]; trajectories are dataparser
    dicts with `poses` [T, 4, 4], `timestamps` [T], `dims` [3], `stationary`.
    """
    dynamic = [t for t in trajectories if not bool(t.get("stationary", False))]
    pruned = []
    for pc, l2w, ts in zip(point_clouds, l2ws, timestamps):
        xyz_world = pc[:, :3] @ np.asarray(l2w)[:3, :3].T + np.asarray(l2w)[:3, 3]
        in_any = np.zeros(pc.shape[0], dtype=bool)
        for traj in dynamic:
            traj_ts = np.asarray(traj["timestamps"], dtype=np.float64)
            match = np.abs(traj_ts - ts) < 1e-3
            if not match.any():
                continue
            ti = int(np.argmax(match))
            size = np.asarray(traj["dims"]) * (1.0 + extra_padding)
            in_any |= points_in_box(xyz_world, np.asarray(traj["poses"][ti]), size)
        pruned.append(pc[~in_any])
    return pruned
