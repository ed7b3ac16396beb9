"""Port splatfacto against the JAX package: the model's render, loss and
gradients at tests/models/test_splatfacto.py's size, and the pipeline's train
steps with a Default-strategy refine, JAX's draws handed to both.

Sizes keep the JAX composites in interpret mode (<= 64 tiles): the model at
32x24 (4 tiles), 256 gaussians, SH degree 2 (and 3); the pipeline on the
synthetic scene at 64x48 (12 tiles), 3,000 slots, 1,000 alive at the start.

Tolerances. Renders: 1e-5 absolute (colours, accumulation), 1e-4 relative
(depth); loss and metrics 1e-5 relative and 2e-6 absolute (the SSIM of a
render against a random target is near 0). Gradients, per parameter: 2e-4 of
that gradient's largest entry plus 1e-3 relative (the composite's backward
divides by 1 - alpha >= 0.001 and both sides sum in other orders), as in
tests/test_torch_splatad_train.py. After an update: Adam's first step is about
lr * sign(g), so parameters are held to 1e-3 * lr where the gradient is above
1e-3 of its largest entry and to 2.001 * lr elsewhere; the absgrad sums to
1e-3 relative plus 1e-3 of their largest. The pipeline's random init puts a
few gaussians just beyond the near plane with a projected covariance whose
fp32 determinant cancels (a c / det > 1e3; on this scene one gaussian 0.2014 m
before the camera, 8.4e3): their means gradient is rounding in both packages,
so those rows are held to 2.001 * lr only. After the refine (two updates)
every row is held to 4.002 * lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.model_components.strategy import DefaultStrategyConfig as JDefault
from neurad_tpu.models import splatfacto as JSF
from neurad_tpu.pipelines.splatfacto_pipeline import SplatfactoPipeline as JPipe
from neurad_tpu.pipelines.splatfacto_pipeline import SplatfactoPipelineConfig as JPipeCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.model_components.strategy import DefaultStrategyConfig as TDefault
from neurad_tpu_torch.models import splatfacto as TSF
from neurad_tpu_torch.pipelines import splatfacto_pipeline as TP

torch.set_num_threads(1)

GRAD_OF_MAX, GRAD_RTOL = 2e-4, 1e-3
SCENE = dict(num_frames=4, image_height=48, image_width=64, focal=50.0, lidar_channels=4, lidar_azimuths=16)
STRATEGY = dict(refine_start_iter=1, refine_every=2, grow_grad2d=1e-6, max_grow_per_refine=256)
PIPE = dict(capacity=3000, num_init=1000, seed=3)


def _model_inputs(sh_degree):
    rng = np.random.default_rng(sh_degree)
    init = TSF.random_init_gaussians(256, extent=8.0, sh_degree=sh_degree)
    init["sh_rest"] = rng.normal(0, 0.05, init["sh_rest"].shape).astype(np.float32)
    init["quats"] = rng.normal(size=(256, 4)).astype(np.float32)
    init["opacities"] = rng.normal(0, 1.0, 256).astype(np.float32)
    init["scales"] += rng.normal(0, 0.3, init["scales"].shape).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.3, -0.2, 10.0]  # looking down -z from z = 10
    K = np.array([[30.0, 0.0, 16.0], [0.0, 30.0, 12.0], [0.0, 0.0, 1.0]], np.float32)
    gt = rng.uniform(0.1, 0.9, (24, 32, 3)).astype(np.float32)
    return init, c2w, K, gt


def _assert_grads(t_grads, j_grads):
    for name, want in bridge.splatfacto_params_from_flax(j_grads).items():
        want, got = want.numpy(), t_grads[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got, want, atol=GRAD_OF_MAX * scale, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("sh_degree", [2, 3])
def test_render_loss_and_gradients_match_jax(sh_degree):
    init, c2w, K, gt = _model_inputs(sh_degree)
    cfg = dict(sh_degree=sh_degree, max_per_tile=64)
    jm = JSF.SplatfactoModel(init_params=init, config=JSF.SplatfactoConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(c2w), jnp.asarray(K), 32, 24)
    tm = TSF.SplatfactoModel(init, TSF.SplatfactoConfig(**cfg))
    tm.load_state_dict(bridge.splatfacto_params_from_flax(jax.tree.map(np.asarray, params)))

    def j_loss(p, offset):
        out = jm.apply(p, jnp.asarray(c2w), jnp.asarray(K), 32, 24, means2d_offset=offset,
                       method=JSF.SplatfactoModel.render)
        total, metrics = jm.apply(p, out, jnp.asarray(gt), method=JSF.SplatfactoModel.loss)
        return total, (metrics, out)

    (j_total, (j_metrics, j_out)), (j_grads, j_off) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.zeros((256, 2)))
    offset = torch.zeros((256, 2), requires_grad=True)
    t_out = tm.render(c2w, K, 32, 24, means2d_offset=offset)
    t_total, t_metrics = tm.loss(t_out, torch.from_numpy(gt))
    t_total.backward()

    np.testing.assert_allclose(t_out["rgb"].detach().numpy(), np.asarray(j_out["rgb"]), atol=1e-5)
    np.testing.assert_allclose(t_out["accumulation"].detach().numpy(), np.asarray(j_out["accumulation"]), atol=1e-5)
    np.testing.assert_allclose(t_out["depth"].detach().numpy(), np.asarray(j_out["depth"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_out["radii"].numpy(), np.asarray(j_out["radii"]))
    assert 0.05 < float(t_out["accumulation"].detach().mean()) < 0.999, "the gaussians cover part of the image"
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=1e-5)
    for k in ("main_loss", "psnr", "ssim"):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-5, atol=2e-6, err_msg=k)
    _assert_grads({n: p.grad.numpy() for n, p in tm.named_parameters()}, jax.tree.map(np.asarray, j_grads))
    want_off = np.asarray(j_off)
    np.testing.assert_allclose(offset.grad.numpy(), want_off, atol=GRAD_OF_MAX * np.abs(want_off).max(),
                               rtol=GRAD_RTOL)


def _pipelines():
    jp = JPipe(JSynth(**SCENE).setup().get_dataparser_outputs(), JPipeCfg(strategy=JDefault(**STRATEGY), **PIPE))
    tp = TP.SplatfactoPipeline(TSynth(**SCENE).setup().get_dataparser_outputs(),
                               TP.SplatfactoPipelineConfig(strategy=TDefault(**STRATEGY), **PIPE), device="cpu")
    jstate, _ = jp.init_state()
    tp.model.load_state_dict(bridge.splatfacto_params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    return jp, jstate, tp, tp.init_state()


def _split_eps(jstate, n):
    """The two normal draws JAX's refine takes after the step from `jstate`."""
    rng_after_step = jax.random.split(jstate.rng)[0]
    _, r = jax.random.split(rng_after_step)
    _, r1, r2 = jax.random.split(r, 3)
    k = min(STRATEGY["max_grow_per_refine"], n)
    return tuple(torch.from_numpy(np.array(jax.random.normal(rr, (k, 3)))) for rr in (r1, r2))


def _ill_conditioned(tp, cam_idx, limit=1e3):
    """[N] bool: the gaussians whose projected 2D covariance (float64) has
    a c / (a c - b^2) above `limit`."""
    from neurad_tpu_torch.models.splatad import viewmat_from_c2w_opengl
    from neurad_tpu_torch.ops.gaussians import quat_scale_to_covariance

    c2w, K, _ = tp._camera(cam_idx)
    with torch.no_grad():
        view = viewmat_from_c2w_opengl(torch.as_tensor(c2w)).double()
        cov = quat_scale_to_covariance(tp.model.quats.double(), torch.exp(tp.model.scales.double()))
        p = tp.model.means.double() @ view[:3, :3].T + view[:3, 3]
        z = p[:, 2]
        jac = torch.zeros((len(z), 2, 3), dtype=torch.float64)
        jac[:, 0, 0], jac[:, 0, 2] = K[0, 0] / z, -K[0, 0] * p[:, 0] / z**2
        jac[:, 1, 1], jac[:, 1, 2] = K[1, 1] / z, -K[1, 1] * p[:, 1] / z**2
        c2 = jac @ (view[:3, :3] @ cov @ view[:3, :3].T) @ jac.transpose(1, 2)
        a, b, c = c2[:, 0, 0], c2[:, 0, 1], c2[:, 1, 1]
        return (a * c / (a * c - b * b)).abs().numpy() > limit


def test_pipeline_steps_and_refine_match_jax(monkeypatch):
    jp, jstate, tp, tstate = _pipelines()
    assert tp.train_indices == jp.train_indices and tp.scene_scale == jp.scene_scale
    lrs = tp._lrs()
    for step in (1, 2):
        old = {n: p.detach().clone() for n, p in tp.model.named_parameters()}
        refine = step == 2
        if refine:
            eps = _split_eps(jstate, PIPE["capacity"])
            monkeypatch.setattr(tp, "_refine", lambda state: TP.SplatfactoPipeline._refine(tp, state, split_eps=eps))
            g_sum_before = tp._grad2d_sum.clone()
        peek = np.random.default_rng()
        peek.bit_generator.state = tp._order.bit_generator.state
        ill = _ill_conditioned(tp, tp.train_indices[int(peek.integers(len(tp.train_indices)))])
        assert ill.mean() < 0.01
        jstate, j_metrics = jp.train_step(jstate)  # both draw the camera from numpy's generator, seeded alike
        tstate, t_metrics = tp.train_step(tstate)
        assert tstate.step == int(jstate.step) == step
        for k in ("total_loss", "main_loss", "psnr", "ssim"):
            np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-5, atol=2e-6, err_msg=k)
        j_new = bridge.splatfacto_params_from_flax(jax.tree.map(np.asarray, jstate.params))
        if not refine:
            g_want = np.asarray(jp._grad2d_sum)
            np.testing.assert_allclose(tp._grad2d_sum.numpy(), g_want, rtol=1e-3, atol=1e-3 * np.abs(g_want).max())
            np.testing.assert_array_equal(tp._count.numpy(), np.asarray(jp._count))
            for name, p in tp.model.named_parameters():
                lr = lrs[name]
                got, want = p.detach().numpy(), j_new[name].numpy()
                g = np.abs(p.grad.numpy())  # the step's gradient (kept until the next step's zero_grad)
                firm = (g > 1e-3 * g.max()) & ~ill.reshape((-1,) + (1,) * (g.ndim - 1))
                diff = np.abs(got - want)
                assert diff[firm].max(initial=0.0) <= 1e-3 * lr + 1e-6 * np.abs(want).max(), name
                assert diff.max() <= 2.001 * lr + 1e-6 * np.abs(want).max(), name
                if g.max() > 0:  # (isotropic init scales: the rotations get no gradient in either package)
                    assert np.abs(got - old[name].numpy()).max() > 0.5 * lr, f"{name} moved"
        else:
            assert float(g_sum_before.abs().max()) > 0 and float(tp._grad2d_sum.abs().max()) == 0.0
            alive_t = TP.alive_mask(tp._gaussians()).numpy()
            alive_j = np.asarray(JSF_alive(jstate))
            np.testing.assert_array_equal(alive_t, alive_j)
            assert alive_t.sum() > PIPE["num_init"], "the refine grew gaussians"
            assert tp.num_alive() == jp.num_alive(jstate)
            for name, p in tp.model.named_parameters():
                want = j_new[name].numpy()
                # the refine copies and splits the parameters of two updates: twice the update's tolerance
                np.testing.assert_allclose(p.detach().numpy(), want, atol=4.002 * lrs[name] + 1e-5 * np.abs(want).max(),
                                           err_msg=name)
    metrics = tp.eval_metrics()
    j_eval = jp.eval_metrics(jstate)
    assert metrics.keys() == j_eval.keys() == {"psnr", "ssim", "num_gaussians"}
    assert metrics["num_gaussians"] == j_eval["num_gaussians"]
    np.testing.assert_allclose(metrics["psnr"], j_eval["psnr"], rtol=1e-3)


def JSF_alive(jstate):
    from neurad_tpu.model_components.strategy import alive_mask

    return alive_mask(jstate.params["params"])


def test_checkpoint_round_trip_resumes_the_same_steps(tmp_path):
    outputs = TSynth(**SCENE).setup().get_dataparser_outputs()
    cfg = TP.SplatfactoPipelineConfig(strategy=TDefault(**STRATEGY), **PIPE)
    a = TP.SplatfactoPipeline(outputs, cfg, device="cpu")
    sa = a.init_state()
    for _ in range(3):
        sa, _ = a.train_step(sa)
    a.save_checkpoint(sa, tmp_path)
    b = TP.SplatfactoPipeline(outputs, cfg, device="cpu")
    sb = b.load_checkpoint(tmp_path, b.init_state())
    assert sb.step == 3
    for _ in range(2):
        sa, ma = a.train_step(sa)
        sb, mb = b.train_step(sb)
        assert float(ma["total_loss"]) == float(mb["total_loss"])
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
