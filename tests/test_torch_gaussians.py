"""Port gaussian projection and tile binning against the JAX package.

Same numpy inputs to both sides. Projection is fp32 on both sides with the
same operation order, except the world->camera matmul (XLA and torch sum the
three products in different orders): 1e-5 relative on every output, with an
absolute floor of 1e-4 on pixel/degree quantities. Binning is integer and must
match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.ops import gaussian_rasterize as JGR
from neurad_tpu.ops import gaussians as JG
from neurad_tpu_torch.ops import gaussian_rasterize as TGR
from neurad_tpu_torch.ops import gaussians as TG

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _gaussians(seed, n=400, centre=(0.0, 0.0, 15.0), spread=(6.0, 4.0, 8.0)):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * np.asarray(spread) + np.asarray(centre)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return means, quats, scales, vel


def _viewmat(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    v = np.eye(4, dtype=np.float32)
    v[:3, :3] = np.eye(3) * 0.9 + q * 0.1
    v[:3, :3] = np.linalg.qr(v[:3, :3])[0] * np.sign(np.diag(np.linalg.qr(v[:3, :3])[1]))
    v[:3, 3] = rng.normal(size=3) * 0.5
    return v


def _close(t_val, j_val, name, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=rtol, atol=atol, err_msg=name)


def test_quat_scale_to_covar6():
    _, quats, scales, _ = _gaussians(0)
    j6 = JG.quat_scale_to_covar6(jnp.asarray(quats), jnp.asarray(scales))
    t6 = TG.quat_scale_to_covar6(torch.from_numpy(quats), torch.from_numpy(scales))
    for i, (a, b) in enumerate(zip(t6, j6)):
        _close(a, b, f"entry {i}", atol=1e-6)


def test_project_gaussians_camera():
    means, quats, scales, vel = _gaussians(1)
    w, h = 120, 80
    K = np.array([[70.0, 0, 61.0], [0, 72.0, 39.0], [0, 0, 1.0]], np.float32)
    view = _viewmat(1)
    lin, ang = np.array([1.5, -0.2, 0.3], np.float32), np.array([0.02, -0.1, 0.05], np.float32)
    j = JG.project_gaussians_camera(
        jnp.asarray(means), covar6=JG.quat_scale_to_covar6(jnp.asarray(quats), jnp.asarray(scales)),
        viewmat=jnp.asarray(view), K=jnp.asarray(K), width=w, height=h, velocities=jnp.asarray(vel),
        camera_linear_velocity=jnp.asarray(lin), camera_angular_velocity=jnp.asarray(ang),
    )
    t = TG.project_gaussians_camera(
        torch.from_numpy(means), TG.quat_scale_to_covar6(torch.from_numpy(quats), torch.from_numpy(scales)),
        torch.from_numpy(view), torch.from_numpy(K), w, h, velocities=torch.from_numpy(vel),
        camera_linear_velocity=torch.from_numpy(lin), camera_angular_velocity=torch.from_numpy(ang),
    )
    assert 0 < int((np.asarray(j.radii) > 0).sum()) < len(means), "some gaussians culled, some kept"
    for name in TG.Projected._fields:
        _close(getattr(t, name), getattr(j, name), name)


def test_project_gaussians_lidar():
    means, quats, scales, vel = _gaussians(2, centre=(0.0, 0.0, 0.0), spread=(20.0, 20.0, 3.0))
    view = _viewmat(2)
    lin, ang = np.array([2.0, 0.1, 0.0], np.float32), np.array([0.0, 0.0, 0.2], np.float32)
    j = JG.project_gaussians_lidar(
        jnp.asarray(means), covar6=JG.quat_scale_to_covar6(jnp.asarray(quats), jnp.asarray(scales)),
        viewmat=jnp.asarray(view), velocities=jnp.asarray(vel),
        lidar_linear_velocity=jnp.asarray(lin), lidar_angular_velocity=jnp.asarray(ang),
    )
    t = TG.project_gaussians_lidar(
        torch.from_numpy(means), TG.quat_scale_to_covar6(torch.from_numpy(quats), torch.from_numpy(scales)),
        torch.from_numpy(view), velocities=torch.from_numpy(vel),
        lidar_linear_velocity=torch.from_numpy(lin), lidar_angular_velocity=torch.from_numpy(ang),
    )
    for name in TG.Projected._fields:
        _close(getattr(t, name), getattr(j, name), name)


@pytest.mark.parametrize("wrap_x", [False, True])
@pytest.mark.parametrize("max_visible", [0, 150])
def test_bin_gaussians(wrap_x, max_visible):
    rng = np.random.default_rng(3)
    n = 300
    if wrap_x:  # spherical degrees, many gaussians straddling the +-180 seam
        means2d = np.stack([rng.uniform(-180, 180, n), rng.uniform(-20, 10, n)], -1)
        means2d[:60, 0] = rng.choice([-179.0, 179.0], 60) + rng.normal(size=60)
        radii = rng.uniform(0.5, 6.0, n)
        radii[60:70] = 60.0  # wider than 16 tiles
        grid = dict(grid_min=(-180.0, -26.0), tile_size=(20.0, 14.0), num_tiles=(18, 3))
    else:  # pixels
        means2d = np.stack([rng.uniform(-10, 110, n), rng.uniform(-10, 90, n)], -1)
        radii = rng.uniform(1.0, 30.0, n)
        grid = dict(grid_min=(0.0, 0.0), tile_size=(16.0, 16.0), num_tiles=(7, 6))
    radii[rng.uniform(size=n) < 0.1] = 0.0  # culled
    depths = rng.uniform(1, 50, n)
    depths[:20] = depths[20:40]  # depth ties: the stable sort must keep index order
    means2d, radii, depths = (x.astype(np.float32) for x in (means2d, radii, depths))
    kw = dict(grid, max_tiles_per_gaussian=16, max_per_tile=24, wrap_x=wrap_x, max_visible=max_visible)
    j = JGR.bin_gaussians(jnp.asarray(means2d), jnp.asarray(radii), jnp.asarray(depths), **kw)
    t = TGR.bin_gaussians(torch.from_numpy(means2d), torch.from_numpy(radii), torch.from_numpy(depths), **kw)
    assert int(j.dropped_pairs) > 0 and int(j.cropped_gaussians) > 0, "the caps must bind in this case"
    np.testing.assert_array_equal(t.tile_valid.numpy(), np.asarray(j.tile_valid))
    np.testing.assert_array_equal(t.tile_gauss.numpy(), np.asarray(j.tile_gauss))
    for name in ("dropped_pairs", "cropped_gaussians", "culled_visible"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
