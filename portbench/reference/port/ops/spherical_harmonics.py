"""Real spherical harmonics basis, levels 1..5 (torch port of
`neurad_tpu/ops/spherical_harmonics.py`; identical constants)."""

from __future__ import annotations

import torch


def components_from_spherical_harmonics(levels: int, directions: torch.Tensor) -> torch.Tensor:
    """SH basis values for unit directions [..., 3] -> [..., levels**2]."""
    assert 1 <= levels <= 5, f"SH levels must be in [1,5], got {levels}"
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x]
    if levels > 2:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if levels > 4:
        comps += [
            2.5033429417967046 * x * y * (xx - yy),
            1.7701307697799304 * y * z * (3 * xx - yy),
            0.9461746957575601 * x * y * (7 * zz - 1),
            0.6690465435572892 * y * z * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * x * z * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * x * z * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)
