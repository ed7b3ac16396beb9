"""Dataparser output contract (torch port of `neurad_tpu/data/dataparsers/base.py`)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from portbench.reference.port.cameras.cameras import Cameras
from portbench.reference.port.cameras.lidars import Lidars
from portbench.reference.port.core.scene_box import SceneBox


@dataclasses.dataclass
class ADDataparserOutputs:
    """Parsed AD sequence.

    images: per-camera-frame uint8/float arrays [H, W, 3] in [0,1].
    point_clouds: per-lidar-scan float arrays [N_i, 5] (x y z intensity timediff).
    trajectories: actor dicts for `actor_data_from_trajectories`.
    """

    cameras: Cameras
    images: List[np.ndarray]
    lidars: Lidars
    point_clouds: List[np.ndarray]
    scene_box: SceneBox
    trajectories: List[dict]
    duration: float
    sensor_idx_to_name: Dict[int, str]
    eval_camera_indices: tuple = ()
    eval_lidar_indices: tuple = ()
    metadata: Optional[dict] = None
