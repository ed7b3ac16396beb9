"""Camera models and ray generation (torch port of
`neurad_tpu/cameras/cameras.py`).

`Cameras` is a dataclass of per-camera tensors; `dataclasses.replace` swaps
fields (the JAX pytree's `.replace`). `generate_rays` is a pure function of
(cameras, indices, coords) that runs on the device of `coords`: the camera
fields are moved there. Camera-type dispatch is branchless, as in the JAX
package: directions for every model are computed elementwise and selected
with `torch.where`.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import torch

from portbench.reference.port.core import poses as pose_utils
from portbench.reference.port.core.structs import RayBundle


class CameraType(enum.IntEnum):
    """Supported camera models (AD datasets are all PERSPECTIVE)."""

    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3
    ORTHOPHOTO = 8


class RollingShutterDirection(enum.IntEnum):
    """Shutter sweep direction."""

    TOP_TO_BOTTOM = 0
    HORIZONTAL = 1
    HORIZONTAL_REVERSED = 2


@dataclasses.dataclass
class Cameras:
    """A batch of cameras. All per-camera fields are [N, ...] tensors.

    `metadata` holds optional per-camera tensors: `velocities` [N,3],
    `rolling_shutter_time` [N,1], `time_to_center_pixel` [N,1],
    `rs_direction` [N,1] int (RollingShutterDirection), `sensor_idxs` [N,1] int.
    """

    camera_to_worlds: torch.Tensor  # [N, 3, 4] OpenGL convention (x right, y up, -z forward)
    fx: torch.Tensor  # [N, 1]
    fy: torch.Tensor  # [N, 1]
    cx: torch.Tensor  # [N, 1]
    cy: torch.Tensor  # [N, 1]
    width: torch.Tensor  # [N, 1] int32
    height: torch.Tensor  # [N, 1] int32
    camera_type: torch.Tensor  # [N, 1] int32 (CameraType)
    distortion_params: Optional[torch.Tensor] = None  # [N, 6]
    times: Optional[torch.Tensor] = None  # [N, 1]
    metadata: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    def replace(self, **changes) -> "Cameras":
        return dataclasses.replace(self, **changes)


def radial_and_tangential_undistort(
    coords: torch.Tensor, distortion_params: torch.Tensor, eps: float = 1e-3, max_iterations: int = 10
) -> torch.Tensor:
    """Invert the OpenCV radial + tangential distortion model by Newton
    iteration: a fixed 10 iterations, the step zeroed where the Jacobian's
    determinant is near-singular."""
    k1, k2, k3, k4 = (distortion_params[..., i] for i in range(4))
    p1, p2 = distortion_params[..., 4], distortion_params[..., 5]
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd

    for _ in range(max_iterations):
        r = x * x + y * y
        d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
        d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
        d_x = 2.0 * x * d_r
        d_y = 2.0 * y * d_r

        fx_res = d * x + 2.0 * p1 * x * y + p2 * (r + 2.0 * x * x) - xd
        fy_res = d * y + 2.0 * p2 * x * y + p1 * (r + 2.0 * y * y) - yd
        fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
        fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
        fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
        fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y

        denom = fy_x * fx_y - fx_x * fy_y
        ok = denom.abs() > eps
        safe = torch.where(ok, denom, torch.ones_like(denom))
        zero = torch.zeros_like(denom)
        x = x + torch.where(ok, (fx_res * fy_y - fy_res * fx_y) / safe, zero)
        y = y + torch.where(ok, (fy_res * fx_x - fx_res * fy_x) / safe, zero)

    return torch.stack([x, y], dim=-1)


def _directions_for_type(coord: torch.Tensor, cam_type: torch.Tensor) -> torch.Tensor:
    """Branchless camera-model dispatch: coord [R, 2] (OpenGL, y already flipped) -> dir [R, 3]."""
    persp = torch.stack([coord[..., 0], coord[..., 1], -torch.ones_like(coord[..., 0])], dim=-1)

    # FISHEYE: equidistant model
    theta = torch.sqrt(torch.sum(coord**2, dim=-1)).clamp(1e-9, math.pi)
    sin_over_theta = torch.sin(theta) / theta
    fish = torch.stack([coord[..., 0] * sin_over_theta, coord[..., 1] * sin_over_theta, -torch.cos(theta)], dim=-1)

    # EQUIRECTANGULAR, from the un-flipped (OpenCV) coordinate: un-flip y for phi
    th = -math.pi * coord[..., 0]
    phi = math.pi * (0.5 + coord[..., 1])
    equi = torch.stack([-torch.sin(th) * torch.sin(phi), torch.cos(phi), -torch.cos(th) * torch.sin(phi)], dim=-1)

    # ORTHOPHOTO: constant -z direction (the caller shifts the origin)
    ortho = torch.tensor([0.0, 0.0, -1.0], dtype=coord.dtype, device=coord.device).expand(persp.shape)

    t = cam_type[..., None]
    out = torch.where(t == CameraType.FISHEYE, fish, persp)
    out = torch.where(t == CameraType.EQUIRECTANGULAR, equi, out)
    out = torch.where(t == CameraType.ORTHOPHOTO, ortho, out)
    return out


_RS_KEYS = ("rolling_shutter_time", "time_to_center_pixel", "rs_direction")


def generate_rays(
    cameras: Cameras,
    camera_indices: torch.Tensor,
    coords: torch.Tensor,
    camera_opt_to_camera: Optional[torch.Tensor] = None,
    disable_distortion: bool = False,
) -> RayBundle:
    """World-space rays for pixels of the indexed cameras.

    camera_indices [R] int indices into the camera batch; coords [R, 2] pixel
    coordinates as (row, col); camera_opt_to_camera optional [R, 3, 4] per-ray
    pose correction. Returns a RayBundle (on the device of `coords`) with
    origins / directions / pixel_area / camera_indices / times and metadata
    {directions_norm, ...per-camera metadata}; rolling shutter is applied when
    the camera metadata carries velocities + rolling_shutter_time +
    time_to_center_pixel."""
    dev = coords.device
    idx = camera_indices.reshape(-1).to(device=dev, dtype=torch.long)
    take = lambda field: field.to(dev)[idx]
    y = coords[..., 0]
    x = coords[..., 1]
    fx, fy, cx, cy = (take(f)[:, 0] for f in (cameras.fx, cameras.fy, cameras.cx, cameras.cy))
    cam_type = take(cameras.camera_type)[:, 0]

    # base + 1-pixel-offset image-plane coords (pixel_area by finite differences)
    def plane_coords(xo: float, yo: float) -> torch.Tensor:
        return torch.stack([(x - cx + xo) / fx, (y - cy + yo) / fy], dim=-1)

    coord_stack = torch.stack([plane_coords(0, 0), plane_coords(1, 0), plane_coords(0, 1)], dim=0)

    if not disable_distortion and cameras.distortion_params is not None:
        dist = take(cameras.distortion_params)  # [R, 6]
        undist = radial_and_tangential_undistort(coord_stack, dist[None])
        skip = (cam_type == CameraType.EQUIRECTANGULAR)[None, :, None]
        coord_stack = torch.where(skip, coord_stack, undist)

    # OpenCV -> OpenGL: flip y
    coord_stack = torch.stack([coord_stack[..., 0], -coord_stack[..., 1]], dim=-1)

    directions_stack = _directions_for_type(
        coord_stack.reshape(-1, 2), cam_type[None].expand(coord_stack.shape[:2]).reshape(-1)
    ).reshape(coord_stack.shape[:-1] + (3,))

    c2w = take(cameras.camera_to_worlds)  # [R, 3, 4]
    if camera_opt_to_camera is not None:
        c2w = pose_utils.multiply(c2w, camera_opt_to_camera)
    rotation = c2w[..., :3, :3]

    # rotate camera-frame directions to world
    world_dirs = torch.sum(directions_stack[:, :, None, :] * rotation[None], dim=-1)  # "srj,rij->sri"
    norms = torch.linalg.norm(world_dirs, dim=-1, keepdim=True)
    world_dirs = world_dirs / norms.clamp_min(1e-12)

    origins = c2w[..., :3, 3]  # [R, 3]
    # ORTHOPHOTO origin shift: origin += R @ (cx_plane, -cy_plane, 0)
    plane = torch.stack([coord_stack[0, :, 0], coord_stack[0, :, 1], torch.zeros_like(coord_stack[0, :, 0])], dim=-1)
    ortho_offset = torch.sum(plane[:, None, :] * rotation, dim=-1)
    origins = torch.where((cam_type == CameraType.ORTHOPHOTO)[:, None], origins + ortho_offset, origins)

    directions = world_dirs[0]
    dx = torch.linalg.norm(directions - world_dirs[1], dim=-1)
    dy = torch.linalg.norm(directions - world_dirs[2], dim=-1)
    pixel_area = (dx * dy)[..., None]

    times = take(cameras.times) if cameras.times is not None else None

    md = cameras.metadata
    metadata = {k: take(v) for k, v in md.items() if k not in _RS_KEYS}
    metadata["directions_norm"] = norms[0]

    if "rolling_shutter_time" in md and "time_to_center_pixel" in md and "velocities" in md:
        duration = take(md["rolling_shutter_time"])  # [R, 1]
        t_center = take(md["time_to_center_pixel"])  # [R, 1]
        if md.get("rs_direction") is not None:
            rs_dir = take(md["rs_direction"])  # [R, 1] int
        else:
            rs_dir = torch.zeros_like(duration, dtype=torch.int32)
        widths = take(cameras.width).to(duration.dtype)
        heights = take(cameras.height).to(duration.dtype)
        row_off = (y[:, None] / heights - 0.5) * duration + t_center
        col_off = (x[:, None] / widths - 0.5) * duration + t_center
        time_offsets = torch.where(rs_dir == RollingShutterDirection.TOP_TO_BOTTOM, row_off, col_off)
        time_offsets = torch.where(rs_dir == RollingShutterDirection.HORIZONTAL_REVERSED, -time_offsets, time_offsets)
        origins = origins + take(md["velocities"]) * time_offsets
        times = times + time_offsets if times is not None else time_offsets

    return RayBundle(
        origins=origins,
        directions=directions,
        pixel_area=pixel_area,
        camera_indices=idx[:, None],
        times=times,
        fars=torch.full_like(pixel_area, 1_000_000.0),
        metadata=metadata,
    )


def full_image_coords(height: int, width: int, device=None) -> torch.Tensor:
    """Pixel-centre grid [(H W), 2] as (row + 0.5, col + 0.5)."""
    rows = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    cols = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    yy, xx = torch.meshgrid(rows, cols, indexing="ij")
    return torch.stack([yy, xx], dim=-1).reshape(-1, 2)
