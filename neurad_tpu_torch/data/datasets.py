"""Datasets: image and lidar access over a dataparser's outputs (torch port
of `neurad_tpu/data/datasets.py`; nerfstudio's InputDataset and
LidarDataset). Host-side containers; the datamanagers make the device batches.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs


class InputDataset:
    """Images by split index, as float32 in [0, 1] or uint8."""

    def __init__(self, outputs: ADDataparserOutputs, split_indices: Optional[List[int]] = None):
        self.outputs = outputs
        self.indices = split_indices if split_indices is not None else list(range(len(outputs.images)))

    def __len__(self) -> int:
        return len(self.indices)

    def get_image_float32(self, i: int) -> np.ndarray:
        img = self.outputs.images[self.indices[i]]
        if img.dtype == np.uint8:
            return img.astype(np.float32) / 255.0
        return img.astype(np.float32)

    def get_image_uint8(self, i: int) -> np.ndarray:
        img = self.outputs.images[self.indices[i]]
        if img.dtype == np.uint8:
            return img
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def __getitem__(self, i: int) -> Dict:
        return {"image": self.get_image_float32(i), "image_idx": self.indices[i]}


class LidarDataset:
    """Point clouds by split index (x, y, z, intensity, timediff columns)."""

    def __init__(self, outputs: ADDataparserOutputs, split_indices: Optional[List[int]] = None):
        self.outputs = outputs
        self.indices = split_indices if split_indices is not None else list(range(len(outputs.point_clouds)))

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> Dict:
        idx = self.indices[i]
        return {"lidar": self.outputs.point_clouds[idx], "lidar_idx": idx}
