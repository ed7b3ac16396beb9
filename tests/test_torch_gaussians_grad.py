"""Gradients of the port's gaussian math against the JAX package: jax.grad and
torch.autograd on the same numpy inputs, for a fixed random cotangent on every
differentiable output of `quat_scale_to_covar6`, `quat_scale_to_covariance`,
`project_gaussians_camera` and `project_gaussians_lidar`.

Both sides are fp32 with the same operation order apart from the world->sensor
matmul, so gradients are held to 1e-4 of the largest entry of each input's
gradient plus 1e-4 relative (the projection divides by depth and by the 2D
determinant, which amplifies last-bit differences). The guards around sqrt and
division (culled gaussians replaced by a safe dummy, clamped determinants)
must keep every gradient finite on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from neurad_tpu.ops import gaussians as JG
from neurad_tpu_torch.ops import gaussians as TG

from test_torch_gaussians import _gaussians, _viewmat

torch.set_num_threads(1)

DIFFERENTIABLE = ("means2d", "depths", "conics", "compensations", "vel2d", "depth_vel")


def _assert_grads(t_grads, j_grads, names):
    for name, tg, jg in zip(names, t_grads, j_grads):
        tg, jg = tg.numpy(), np.asarray(jg)
        assert np.isfinite(jg).all() and np.isfinite(tg).all(), name
        scale = np.abs(jg).max()
        assert scale > 0, name
        np.testing.assert_allclose(tg, jg, atol=1e-4 * scale, rtol=1e-4, err_msg=name)


def _cots(seed, proj):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=np.shape(getattr(proj, name))).astype(np.float32) for name in DIFFERENTIABLE}


def test_covariance_grads():
    _, quats, scales, _ = _gaussians(10)
    rng = np.random.default_rng(11)
    cot6 = [rng.normal(size=len(quats)).astype(np.float32) for _ in range(6)]
    cot33 = rng.normal(size=(len(quats), 3, 3)).astype(np.float32)

    def jloss(q, s):
        c6 = JG.quat_scale_to_covar6(q, s)
        return sum(jnp.sum(c * g) for c, g in zip(c6, cot6)) + jnp.sum(JG.quat_scale_to_covariance(q, s) * cot33)

    tq, ts = torch.from_numpy(quats).requires_grad_(True), torch.from_numpy(scales).requires_grad_(True)
    c6 = TG.quat_scale_to_covar6(tq, ts)
    tloss = sum(torch.sum(c * torch.from_numpy(g)) for c, g in zip(c6, cot6))
    cov = TG.quat_scale_to_covariance(tq, ts)
    np.testing.assert_allclose(cov.detach().numpy(),
                               np.asarray(JG.quat_scale_to_covariance(jnp.asarray(quats), jnp.asarray(scales))),
                               rtol=1e-5, atol=1e-6)
    tloss = tloss + torch.sum(cov * torch.from_numpy(cot33))
    tloss.backward()
    _assert_grads((tq.grad, ts.grad), jax.grad(jloss, argnums=(0, 1))(jnp.asarray(quats), jnp.asarray(scales)),
                  ("quats", "scales"))


def test_project_gaussians_camera_grads():
    means, quats, scales, vel = _gaussians(1)
    w, h = 120, 80
    K = np.array([[70.0, 0, 61.0], [0, 72.0, 39.0], [0, 0, 1.0]], np.float32)
    view = _viewmat(1)
    lin, ang = np.array([1.5, -0.2, 0.3], np.float32), np.array([0.02, -0.1, 0.05], np.float32)

    def jproj(m, q, s, v, vm):
        return JG.project_gaussians_camera(
            m, covar6=JG.quat_scale_to_covar6(q, s), viewmat=vm, K=jnp.asarray(K), width=w, height=h, velocities=v,
            camera_linear_velocity=jnp.asarray(lin), camera_angular_velocity=jnp.asarray(ang))

    args = (means, quats, scales, vel, view)
    cots = _cots(12, jproj(*map(jnp.asarray, args)))
    jloss = lambda *a: sum(jnp.sum(getattr(jproj(*a), n) * cots[n]) for n in DIFFERENTIABLE)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    m, q, s, v, vm = leaves
    t = TG.project_gaussians_camera(m, TG.quat_scale_to_covar6(q, s), vm, torch.from_numpy(K), w, h, velocities=v,
                                    camera_linear_velocity=torch.from_numpy(lin),
                                    camera_angular_velocity=torch.from_numpy(ang))
    assert 0 < int((t.radii > 0).sum()) < len(means), "some gaussians culled (behind the camera), some kept"
    sum(torch.sum(getattr(t, n) * torch.from_numpy(cots[n])) for n in DIFFERENTIABLE).backward()
    _assert_grads([x.grad for x in leaves], j_grads, ("means", "quats", "scales", "velocities", "viewmat"))


def test_project_gaussians_lidar_grads():
    means, quats, scales, vel = _gaussians(2, centre=(0.0, 0.0, 0.0), spread=(20.0, 20.0, 3.0))
    view = _viewmat(2)
    # at the sensor's origin, inside min_range: replaced by the safe dummy, zero gradient, no NaN
    means[:5] = -view[:3, :3].T @ view[:3, 3] + 0.01
    lin, ang = np.array([2.0, 0.1, 0.0], np.float32), np.array([0.0, 0.0, 0.2], np.float32)

    def jproj(m, q, s, v, vm):
        return JG.project_gaussians_lidar(
            m, covar6=JG.quat_scale_to_covar6(q, s), viewmat=vm, velocities=v,
            lidar_linear_velocity=jnp.asarray(lin), lidar_angular_velocity=jnp.asarray(ang))

    args = (means, quats, scales, vel, view)
    cots = _cots(13, jproj(*map(jnp.asarray, args)))
    jloss = lambda *a: sum(jnp.sum(getattr(jproj(*a), n) * cots[n]) for n in DIFFERENTIABLE)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    m, q, s, v, vm = leaves
    t = TG.project_gaussians_lidar(m, TG.quat_scale_to_covar6(q, s), vm, velocities=v,
                                   lidar_linear_velocity=torch.from_numpy(lin),
                                   lidar_angular_velocity=torch.from_numpy(ang))
    sum(torch.sum(getattr(t, n) * torch.from_numpy(cots[n])) for n in DIFFERENTIABLE).backward()
    assert float(m.grad[:5].abs().max()) == 0.0
    _assert_grads([x.grad for x in leaves], j_grads, ("means", "quats", "scales", "velocities", "viewmat"))
