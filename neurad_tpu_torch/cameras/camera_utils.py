"""Camera utility functions: pose orientation, distortion params, interpolation
(torch port of `neurad_tpu/cameras/camera_utils.py`; counterpart of
`nerfstudio/cameras/camera_utils.py`: get_distortion_params,
rotation_matrix_between 761, auto_orient_and_center_poses ~800, viewmatrix,
get_interpolated_poses).

The distortion vector, `rotation_matrix_between` and `viewmatrix` are numpy.
Pose composition and quaternion interpolation go through the port's
`core/poses` in float32, as the JAX package's `jnp` calls compute them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from neurad_tpu_torch.core import poses as pose_utils


def get_distortion_params(
    k1: float = 0.0, k2: float = 0.0, k3: float = 0.0, k4: float = 0.0, p1: float = 0.0, p2: float = 0.0
) -> np.ndarray:
    """OpenCV radial (k1..k4) + tangential (p1, p2) parameter vector."""
    return np.array([k1, k2, k3, k4, p1, p2], dtype=np.float32)


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (`camera_utils.py:761-790`)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-8:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def viewmatrix(lookat: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """OpenGL c2w [3,4] from look-at (`camera_utils.py` viewmatrix)."""
    z = -lookat / np.linalg.norm(lookat)  # camera -z = view dir
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, pos], axis=-1)


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses"
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient the world so mean camera-up is +z, center translations
    (`camera_utils.py` auto_orient_and_center_poses; methods 'up'|'none',
    centering 'poses'|'none'). poses: [N, 3, 4] OpenGL c2w.

    Returns (oriented poses [N,3,4] float32, applied transform [3,4]).
    """
    origins = poses[:, :3, 3]
    translation = origins.mean(0) if center_method == "poses" else np.zeros(3)

    if method == "up":
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        rot = rotation_matrix_between(up, np.array([0.0, 0.0, 1.0]))
    else:
        rot = np.eye(3)

    transform = np.concatenate([rot, (-rot @ translation)[:, None]], axis=-1).astype(poses.dtype)
    as32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    oriented = pose_utils.multiply(as32(transform), as32(poses)).numpy()
    return oriented, transform


def get_interpolated_poses(pose_a: np.ndarray, pose_b: np.ndarray, steps: int = 10) -> np.ndarray:
    """Slerp+lerp interpolated camera path between two [3,4] poses
    (`camera_utils.py` get_interpolated_poses)."""
    ts = np.linspace(0.0, 1.0, steps)
    as32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    qa = pose_utils.rotmat_to_quat(as32(pose_a[:3, :3]))
    qb = pose_utils.rotmat_to_quat(as32(pose_b[:3, :3]))
    out = []
    for t in ts:
        q = pose_utils.quat_slerp(qa, qb, torch.tensor(t, dtype=torch.float32))
        r = pose_utils.quat_to_rotmat(q).numpy()
        p = pose_a[:3, 3] * (1 - t) + pose_b[:3, 3] * t
        out.append(np.concatenate([r, p[:, None]], axis=-1))
    return np.stack(out)
