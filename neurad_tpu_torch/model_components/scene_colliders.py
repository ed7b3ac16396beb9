"""Scene colliders: near and far bounds of a ray bundle (torch port of
`neurad_tpu/model_components/scene_colliders.py`; nerfstudio's NearFarCollider,
AABBBoxCollider and SphereCollider as functions RayBundle -> RayBundle)."""

from __future__ import annotations

import torch

from neurad_tpu_torch.core.math_utils import intersect_aabb
from neurad_tpu_torch.core.structs import RayBundle


def near_far_collider(bundle: RayBundle, near_plane: float, far_plane: float) -> RayBundle:
    """Constant near and far planes."""
    ones = torch.ones_like(bundle.pixel_area)
    return bundle.replace(nears=ones * near_plane, fars=ones * far_plane)


def aabb_box_collider(bundle: RayBundle, aabb: torch.Tensor, near_plane: float = 0.0) -> RayBundle:
    """The ray's entry into and exit from the box `aabb` [2, 3]; a ray that
    misses gets far = near + 1e-6 (an empty integration domain)."""
    flat = torch.cat([aabb[0], aabb[1]])
    t_min, t_max = intersect_aabb(bundle.origins, bundle.directions, flat)
    nears = t_min.clamp_min(near_plane)[:, None]
    fars = torch.maximum(t_max, nears[:, 0] + 1e-6)[:, None]
    return bundle.replace(nears=nears, fars=fars)


def sphere_collider(bundle: RayBundle, center: torch.Tensor, radius: float, near_plane: float = 0.0) -> RayBundle:
    """The ray's entry into and exit from a sphere."""
    oc = bundle.origins - center
    b = torch.sum(oc * bundle.directions, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius**2
    sq = torch.sqrt((b * b - c).clamp_min(0.0))
    nears = (-b - sq).clamp_min(near_plane)[:, None]
    fars = torch.maximum((-b + sq)[:, None], nears + 1e-6)
    return bundle.replace(nears=nears, fars=fars)
