"""SplatAD's loss terms in the port against the JAX package: values and input
gradients of `masked_mean`, `masked_quantile`, `psnr`, `ssim`, the camera
optimizers' regularisers and metrics, and the model's `camera_loss` and
`lidar_loss`. fp32 on both sides; values to 1e-6 relative (1e-5 for ssim,
whose two convolutions sum 11 taps in other orders), gradients to 1e-5 of
their largest entry.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.cameras import camera_optimizers as JC
from neurad_tpu.model_components import losses as JL
from neurad_tpu.model_components.dynamic_actors import empty_actor_data as j_empty
from neurad_tpu.models import splatad as JS
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.cameras import camera_optimizers as TCam
from neurad_tpu_torch.model_components import losses as TL
from neurad_tpu_torch.model_components.dynamic_actors import empty_actor_data as t_empty
from neurad_tpu_torch.models import splatad as TS

torch.set_num_threads(1)


def _grad_close(t_grad, j_grad, name=""):
    j_grad = np.asarray(j_grad)
    scale = max(float(np.abs(j_grad).max()), 1e-12)
    np.testing.assert_allclose(t_grad.numpy(), j_grad, atol=1e-5 * scale, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("q", [0.95, 0.5, 0.0, 1.0])
@pytest.mark.parametrize("n_masked", [0, 1, 37])
def test_masked_quantile_and_mean(q, n_masked):
    rng = np.random.default_rng(0)
    x = rng.normal(size=100).astype(np.float32)
    mask = np.zeros(100, bool)
    mask[rng.permutation(100)[:n_masked]] = True
    jq, jg = jax.value_and_grad(lambda v: JL.masked_quantile(v, jnp.asarray(mask), q))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tq = TL.masked_quantile(tx, torch.from_numpy(mask), q)
    if n_masked:
        np.testing.assert_allclose(float(tq.detach()), float(jq), rtol=1e-6)
        np.testing.assert_allclose(float(tq.detach()), np.quantile(x[mask].astype(np.float64), q), rtol=1e-5, atol=1e-6)
        tq.backward()
        _grad_close(tx.grad, jg)
    else:  # empty mask: +inf on both sides (nothing to take a quantile of)
        assert np.isinf(float(tq.detach())) and np.isinf(float(jq))
    jm, jmg = jax.value_and_grad(lambda v: JL.masked_mean(v**2, jnp.asarray(mask)))(jnp.asarray(x))
    tx2 = torch.from_numpy(x).requires_grad_(True)
    tm = TL.masked_mean(tx2**2, torch.from_numpy(mask))
    np.testing.assert_allclose(float(tm.detach()), float(jm), rtol=1e-6, atol=1e-12)
    tm.backward()
    _grad_close(tx2.grad, jmg)


def test_ssim_and_psnr():
    rng = np.random.default_rng(1)
    pred = rng.uniform(size=(40, 52, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(size=pred.shape) * 0.1, 0, 1).astype(np.float32)
    js, jg = jax.value_and_grad(JL.ssim)(jnp.asarray(pred), jnp.asarray(gt))
    tp = torch.from_numpy(pred).requires_grad_(True)
    ts = TL.ssim(tp, torch.from_numpy(gt))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    assert 0.1 < float(ts) < 0.99
    ts.backward()
    _grad_close(tp.grad, jg)
    jp, jpg = jax.value_and_grad(JL.psnr)(jnp.asarray(pred), jnp.asarray(gt))
    tp2 = torch.from_numpy(pred).requires_grad_(True)
    tpsnr = TL.psnr(tp2, torch.from_numpy(gt))
    np.testing.assert_allclose(float(tpsnr), float(jp), rtol=1e-6)
    tpsnr.backward()
    _grad_close(tp2.grad, jpg)


@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_camera_optimizer_regulariser_weights_and_metrics(mode):
    """Non-zero adjustments (at zero the norm's gradient is NaN in JAX and 0 in
    torch), axis weights, non-trainable cameras."""
    rng = np.random.default_rng(2)
    adj = (rng.normal(size=(5, 6)) * 0.05).astype(np.float32)
    kw = dict(weights=(1.0, 2.0, 0.5, 1.0, 3.0, 1.0), non_trainable_camera_indices=(1, 3))
    jc = JC.CameraOptimizer(num_cameras=5, mode=mode, **kw)
    tc = TCam.CameraOptimizer(5, mode=mode, **kw)
    tc.load_state_dict({"pose_adjustment": torch.from_numpy(adj)})
    params = {"params": {"pose_adjustment": jnp.asarray(adj)}}
    s2w = np.broadcast_to(np.eye(4, dtype=np.float32)[:3], (2, 3, 4)).copy()
    s2w[:, :, 3] = rng.normal(size=(2, 3))
    for idx in (0, 1):  # a trainable and a non-trainable camera
        want = jc.apply(params, jnp.asarray(s2w[:1]), jnp.asarray(idx), method=JC.CameraOptimizer.apply_to_camera_pose)
        got = tc.apply_to_camera_pose(torch.from_numpy(s2w[:1]), torch.tensor(idx))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(tc.apply_to_camera_pose(torch.from_numpy(s2w[:1]), torch.tensor(1)).detach().numpy(),
                                  s2w[:1])
    jl, jg = jax.value_and_grad(
        lambda p: jc.apply(p, method=JC.CameraOptimizer.regularization_loss))(params)
    tl = tc.regularization_loss()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    tl.backward()
    jgrad, trainable = np.asarray(jg["params"]["pose_adjustment"]), [0, 2, 4]
    _grad_close(tc.pose_adjustment.grad[trainable], jgrad[trainable])
    # a masked camera's rotation is exactly 0: the norm's gradient there is NaN in JAX, 0 in torch
    assert np.isnan(jgrad[[1, 3], 3:]).all() and float(tc.pose_adjustment.grad[[1, 3]].abs().max()) == 0.0
    jm = jc.apply(params, method=JC.CameraOptimizer.metrics)
    tm = tc.metrics()
    assert tm.keys() == jm.keys()
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert TCam.CameraOptimizer(5).metrics() == {} and float(TCam.CameraOptimizer(5).regularization_loss()) == 0.0


def test_camera_velocity_optimizer_regulariser():
    rng = np.random.default_rng(3)
    p = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in
         (("linear_velocity_adjustment", (4, 3)), ("angular_velocity_adjustment", (4, 3)),
          ("time_to_center_pixel_adjustment", (2,)))}
    jv = JC.CameraVelocityOptimizer(num_cameras=4, num_unique_cameras=2, enabled=True, zero_initial_velocities=True)
    tv = TCam.CameraVelocityOptimizer(4, 2, enabled=True, zero_initial_velocities=True)
    tv.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    params = {"params": {k: jnp.asarray(v) for k, v in p.items()}}
    jl = jv.apply(params, method=JC.CameraVelocityOptimizer.regularization_loss)
    np.testing.assert_allclose(float(tv.regularization_loss()), float(jl), rtol=1e-6)
    base = rng.normal(size=(1, 3)).astype(np.float32)
    want = jv.apply(params, jnp.asarray(base), jnp.asarray([2]), method=JC.CameraVelocityOptimizer.get_linear_velocity)
    got = tv.get_linear_velocity(torch.from_numpy(base), torch.tensor([2]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-7)
    assert float(TCam.CameraVelocityOptimizer(4, 2).regularization_loss()) == 0.0


@pytest.fixture(scope="module")
def models():
    """The two models at a tiny size with bridged parameters (only the gaussian
    parameters and the regularisers enter the losses)."""
    rng = np.random.default_rng(4)
    n = 50
    init = dict(means=rng.normal(size=(n, 3)), scales_log=rng.normal(size=(n, 3)) * 0.3 - 1.0,
                quats=rng.normal(size=(n, 4)), features=rng.uniform(size=(n, 16)),
                opacities_logit=rng.normal(size=n), ids=np.zeros(n, np.int32))
    init = {k: v.astype(np.float32) if v.dtype != np.int32 else v for k, v in init.items()}
    jm = JS.SplatADModel(init_data=JS.GaussianInit(**init), actor_data=j_empty())
    params = jm.init(jax.random.PRNGKey(0), method=JS.SplatADModel.init_all)
    tm = TS.SplatADModel(TS.GaussianInit(**init), t_empty())
    # a scene without actors: the JAX model creates no actor parameters, the port's are empty tensors
    tm.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, params)), strict=False)
    return jm, params, tm


def test_camera_loss(models):
    jm, params, tm = models
    rng = np.random.default_rng(5)
    rgb = rng.uniform(size=(32, 40, 3)).astype(np.float32)
    gt = np.clip(rgb + rng.normal(size=rgb.shape) * 0.1, 0, 1).astype(np.float32)
    extra = {"binning_dropped_pairs": 3, "binning_cropped_gaussians": 1}

    def jloss(p, pred):
        out = {"rgb": pred, **{k: jnp.asarray(v) for k, v in extra.items()}}
        return jm.apply(p, out, jnp.asarray(gt), method=JS.SplatADModel.camera_loss)

    (jt, jmet), (jgp, jgrgb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(rgb))
    trgb = torch.from_numpy(rgb).requires_grad_(True)
    tt, tmet = tm.camera_loss({"rgb": trgb, **{k: torch.tensor(v) for k, v in extra.items()}}, gt)
    assert tmet.keys() == jmet.keys()
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    tm.zero_grad()
    tt.backward()
    _grad_close(trgb.grad, jgrgb, "rgb")
    _grad_close(tm.scales.grad, jgp["params"]["scales"], "scales")
    _grad_close(tm.opacities.grad, jgp["params"]["opacities"], "opacities")


def test_lidar_loss(models):
    jm, params, tm = models
    rng = np.random.default_rng(6)
    m = 300
    rp = np.stack([rng.uniform(-180, 180, m), rng.uniform(-25, 14, m), rng.uniform(3, 40, m),
                   rng.uniform(-0.05, 0.05, m), rng.uniform(0, 1, m)], -1).astype(np.float32)
    did_return = rng.uniform(size=m) > 0.2
    valid = np.arange(m) < 260
    did_return &= valid
    outs = {"depth": rp[:, 2:3] + rng.normal(size=(m, 1)) * 2, "intensity": rng.uniform(size=(m, 1)),
            "ray_drop_logits": rng.normal(size=(m, 1)) * 3, "alpha_sum_until_points": rng.uniform(size=(m, 1)) * 0.3}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    counters = {"binning_dropped_pairs": 2, "binning_cropped_gaussians": 0, "points_overflowed": 7}

    def jloss(o):
        o = {**o, **{k: jnp.asarray(v) for k, v in counters.items()}}
        return jm.apply(params, o, jnp.asarray(rp), jnp.asarray(did_return), jnp.asarray(valid),
                        method=JS.SplatADModel.lidar_loss)

    (jt, jmet), jg = jax.value_and_grad(jloss, has_aux=True)({k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in outs.items()}
    tt, tmet = tm.lidar_loss({**touts, **{k: torch.tensor(v) for k, v in counters.items()}}, rp, did_return, valid)
    assert tmet.keys() == jmet.keys()
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5, atol=1e-7, err_msg=key)
    tt.backward()
    for key in outs:
        _grad_close(touts[key].grad, jg[key], key)
