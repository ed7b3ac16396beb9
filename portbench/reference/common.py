"""What both models' camera requests share: the camera a request patches, the
actors' trajectories a request carries, and the compute precision."""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from portbench.reference.port.core import poses as pose_utils
from portbench.reference.port.fields.mlp import MLP
from portbench.reference.port.model_components.cnns import BasicBlock, RGBDecoderCNN
from portbench.reference.port.model_components.dynamic_actors import actor_data_from_trajectories
from portbench.reference.port.precision import FP8


def camera_index(scene, camera_name: str) -> int:
    """The first camera of the named sensor (the one a request re-poses)."""
    cams = scene.cameras
    names = {v: k for k, v in scene.sensor_idx_to_name.items()}
    sensor = names.get(camera_name, 0)
    if "sensor_idxs" in cams.metadata:
        matches = np.nonzero(cams.metadata["sensor_idxs"][:, 0].numpy() == sensor)[0]
        return int(matches[0]) if len(matches) else 0
    return 0


def patched_cameras(cams, cam_idx: int, pose, time: float):
    """The scene's cameras with camera `cam_idx` at `pose` ([3|4, 4]) and `time`."""
    c2w = cams.camera_to_worlds.clone()
    c2w[cam_idx] = torch.as_tensor(np.asarray(pose, dtype=np.float32)[:3, :4])
    times = cams.times.clone() if cams.times is not None else None
    if times is not None:
        times[cam_idx] = time
    return cams.replace(camera_to_worlds=c2w, times=times)


@torch.no_grad()
def set_actor_trajectories(actors, trajectories: Sequence[dict], device) -> None:
    """The actors' trajectory parameters from `trajectories` (timestamps and
    sizes as the scene's, poses moved)."""
    data = actor_data_from_trajectories([
        {"poses": np.asarray(a["poses"], dtype=np.float32), "timestamps": np.asarray(a["timestamps"]),
         "dims": np.asarray(a["dims"], dtype=np.float32), "symmetric": a.get("symmetric", True),
         "deformable": a.get("deformable", False)}
        for a in trajectories
    ])
    poses = torch.from_numpy(data.poses).to(device)
    actors.actor_positions.copy_(poses[..., :3, 3])
    actors.actor_rotations_6d.copy_(pose_utils.rotmat_to_6d(poses[..., :3, :3]))
    actors.actor_vel_linear.copy_(torch.from_numpy(data.vel_linear))
    actors.actor_vel_angular.copy_(torch.from_numpy(data.vel_angular))


def set_precision(model: torch.nn.Module, precision: str) -> None:
    """Every MLP and convolution stack of `model` computes in the control's
    `precision`: "fp8" (fp8 operands, fp32 sums: the control of a
    configuration in bf16) or "tf32" (the control of one in fp32, where
    PyTorch's defaults leave matmuls in fp32 and let cuDNN's convolutions use
    TF32: the MLPs in TF32, under `precision_context`, and the convolutions
    in bf16)."""
    mlp_dtype = {"tf32": None, "fp8": FP8}[precision]
    conv_dtype = {"tf32": torch.bfloat16, "fp8": FP8}[precision]
    for m in model.modules():
        if isinstance(m, MLP):
            m.compute_dtype = mlp_dtype
        elif isinstance(m, (BasicBlock, RGBDecoderCNN)):
            m.compute_dtype = conv_dtype


@contextlib.contextmanager
def precision_context(precision: str):
    """Matmuls in TF32 inside, where `precision` is "tf32"; as they were otherwise."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32" or old
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
