"""Port core pieces of the serving path against the JAX package: poses and
trajectory interpolation, Lie exp maps, camera optimizers, dynamic actors.

All fp32 on both sides with the same operation order: 1e-5 absolute (poses,
unit vectors and metres in single digits to tens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.cameras import camera_optimizers as JCO
from neurad_tpu.core import lie as JL
from neurad_tpu.core import poses as JP
from neurad_tpu.model_components import dynamic_actors as JDA
from neurad_tpu_torch.cameras import camera_optimizers as TCO
from neurad_tpu_torch.core import lie as TL
from neurad_tpu_torch.core import poses as TP
from neurad_tpu_torch.model_components import dynamic_actors as TDA

torch.set_num_threads(1)

ATOL = 1e-5


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(JP.quat_to_rotmat(jnp.asarray(q.astype(np.float32))))


def test_rotation_6d_roundtrip_and_to4x4():
    rng = np.random.default_rng(0)
    r = _rotations(rng, 7)
    d6 = TP.rotmat_to_6d(torch.from_numpy(r))
    np.testing.assert_allclose(d6.numpy(), np.asarray(JP.rotmat_to_6d(jnp.asarray(r))), atol=ATOL)
    noisy = (d6.numpy() + rng.normal(size=d6.shape) * 0.05).astype(np.float32)
    np.testing.assert_allclose(
        TP.rot6d_to_rotmat(torch.from_numpy(noisy)).numpy(), np.asarray(JP.rot6d_to_rotmat(jnp.asarray(noisy))),
        atol=ATOL,
    )
    pose = rng.normal(size=(2, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(TP.to4x4(torch.from_numpy(pose)).numpy(), np.asarray(JP.to4x4(jnp.asarray(pose))))


def test_interpolate_trajectories_and_velocities():
    rng = np.random.default_rng(1)
    a, t = 3, 5
    poses9d = rng.normal(size=(a, t, 9)).astype(np.float32)
    times = np.sort(rng.uniform(0, 10, t)).astype(np.float32)
    query = np.array([-1.0, 0.0, times[1], 3.3, 7.7, 12.0], np.float32)
    mask = rng.uniform(size=(t, a)) > 0.3
    ji, jv = JP.interpolate_trajectories_6d(jnp.asarray(poses9d), jnp.asarray(times), jnp.asarray(query),
                                            jnp.asarray(mask))
    ti, tv = TP.interpolate_trajectories_6d(torch.from_numpy(poses9d), torch.from_numpy(times),
                                            torch.from_numpy(query), torch.from_numpy(mask))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    vels = rng.normal(size=(t, a, 6)).astype(np.float32)
    np.testing.assert_allclose(
        TP.interpolate_velocities(torch.from_numpy(vels), torch.from_numpy(times), torch.from_numpy(query)).numpy(),
        np.asarray(JP.interpolate_velocities(jnp.asarray(vels), jnp.asarray(times), jnp.asarray(query))),
        atol=1e-4,
    )


@pytest.mark.parametrize("name", ["exp_map_SO3xR3", "exp_map_SE3"])
def test_exp_maps(name):
    rng = np.random.default_rng(2)
    tangent = rng.normal(size=(6, 6)).astype(np.float32)
    tangent[0, 3:] = 1e-6  # small-angle branch
    np.testing.assert_allclose(
        getattr(TL, name)(torch.from_numpy(tangent)).numpy(), np.asarray(getattr(JL, name)(jnp.asarray(tangent))),
        atol=ATOL,
    )


@pytest.mark.parametrize("mode", ["off", "SO3xR3", "SE3"])
def test_camera_optimizer_apply_to_camera_pose(mode):
    rng = np.random.default_rng(3)
    adj = (rng.normal(size=(4, 6)) * 0.1).astype(np.float32)
    c2w = rng.normal(size=(1, 3, 4)).astype(np.float32)
    jm = JCO.CameraOptimizer(num_cameras=4, mode=mode)
    params = {"params": {"pose_adjustment": jnp.asarray(adj)}} if mode != "off" else {}
    j = jm.apply(params, jnp.asarray(c2w), jnp.asarray(2), method=JCO.CameraOptimizer.apply_to_camera_pose)
    tm = TCO.CameraOptimizer(4, mode=mode)
    if mode != "off":
        tm.pose_adjustment.data = torch.from_numpy(adj)
    with torch.no_grad():
        t = tm.apply_to_camera_pose(torch.from_numpy(c2w), torch.tensor(2))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_camera_velocity_optimizer():
    rng = np.random.default_rng(4)
    lin, ang = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    tc = rng.normal(size=(2,)).astype(np.float32)
    jm = JCO.CameraVelocityOptimizer(num_cameras=4, num_unique_cameras=2, enabled=True)
    params = {"params": {"linear_velocity_adjustment": lin, "angular_velocity_adjustment": ang,
                         "time_to_center_pixel_adjustment": tc}}
    base = rng.normal(size=(1, 3)).astype(np.float32)
    tm = TCO.CameraVelocityOptimizer(4, 2, enabled=True)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params["params"].items()})
    idx = np.array([3])
    for fn in ("get_linear_velocity", "get_angular_velocity"):
        j = jm.apply(params, jnp.asarray(base), jnp.asarray(idx), method=getattr(JCO.CameraVelocityOptimizer, fn))
        t = getattr(tm, fn)(torch.from_numpy(base), torch.from_numpy(idx))
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL)
    j = jm.apply(params, jnp.asarray([1]), method=JCO.CameraVelocityOptimizer.get_time_to_center_pixel_adjustment)
    t = tm.get_time_to_center_pixel_adjustment(torch.tensor([1]))
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL)


def _trajectories():
    rng = np.random.default_rng(5)
    trajs = []
    for a in range(2):
        ts = np.sort(rng.uniform(0, 4, 4)) + a * 0.5
        poses = np.broadcast_to(np.eye(4, dtype=np.float32), (4, 4, 4)).copy()
        poses[:, :3, :3] = _rotations(rng, 4)
        poses[:, :3, 3] = rng.normal(size=(4, 3)) * 5
        trajs.append({
            "poses": poses, "timestamps": ts, "dims": rng.uniform(1, 4, 3), "symmetric": bool(a), "deformable": False,
            "linear_velocities_global": rng.normal(size=(4, 3)), "angular_velocities_local": rng.normal(size=(4, 3)),
        })
    return trajs


@pytest.mark.parametrize("edits", [None, dict(lateral=0.7, longitudinal=-0.4, rotation=0.3, height=0.2, index=1)])
def test_dynamic_actors(edits):
    trajs = _trajectories()
    jd, td = JDA.actor_data_from_trajectories(trajs), TDA.actor_data_from_trajectories(trajs)
    for field in ("unique_timestamps", "poses", "present", "sizes", "symmetric", "vel_linear", "vel_angular"):
        np.testing.assert_array_equal(getattr(td, field), getattr(jd, field))
    jm = JDA.DynamicActors(data=jd)
    query = np.array([0.3, 1.7, 3.9], np.float32)
    je = JDA.ActorEdits(**edits) if edits else None
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(query))
    jb, jv = jm.apply(params, jnp.asarray(query), je, method=JDA.DynamicActors.get_boxes2world)
    jvel = jm.apply(params, jnp.asarray(query), method=JDA.DynamicActors.get_velocities)
    tm = TDA.DynamicActors(td)
    tm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params["params"].items()})
    with torch.no_grad():
        tb, tv = tm.get_boxes2world(torch.from_numpy(query), TDA.ActorEdits(**edits) if edits else None)
        tvel = tm.get_velocities(torch.from_numpy(query))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), atol=1e-4)
