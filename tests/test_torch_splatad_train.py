"""Port SplatAD training against the JAX package, the slice as a whole: one
camera step and one lidar step (loss, every metric, every parameter's
gradient, every parameter and Adam moment after the update), an MCMC refine
with JAX's draws handed to both, twenty alternating steps, a checkpoint round
trip, the train script and `ClosedLoopState.from_run_dir`.

Size: the `SMALL` / `SCENE` configuration of tests/test_torch_splatad.py
(128x128 camera = 64 tiles, 54 lidar tiles, 3000 gaussians), so the JAX side
runs its Pallas forward and backward kernels in interpret mode, with
`num_downscales=0`. The JAX parameters are carried across with
`splatad_params_from_flax`, as are JAX's gradients and optax's moments.

Tolerances. With fp32 decoders on both sides the losses and metrics are held
to 2e-5 relative (5e-4 for metrics that are thresholded counts or quantiles).
Gradients are held, per parameter, to 2e-4 of that gradient's largest entry
plus 1e-3 relative: the composites' backward divides by 1 - alpha >= 0.001,
and both sides sum thousands of fp32 terms per gaussian in other orders. Adam's
first update is lr * g / (|g| + 1e-15), about lr * sign(g): where a gradient
entry is below 1e-3 of its tensor's largest, rounding may flip its sign, so
parameters after the update are held to 1e-3 * lr where the gradient is above
that mark and to 2.001 * lr elsewhere. At the bf16 default the decoders round
at other points in XLA and torch (the `DECODED` tolerance of the serving
tests, 1e-2), which the loss inherits.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.data.full_image_datamanager import CameraSample as JCameraSample
from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManagerConfig as JDMC
from neurad_tpu.model_components.strategy import MCMCStrategyConfig as JMCMC
from neurad_tpu.models import splatad as JS
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipeline as JPipe
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipelineConfig as JPipeCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.data.full_image_datamanager import CameraSample as TCameraSample
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig as TDMC
from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig as TMCMC
from neurad_tpu_torch.models import splatad as TS
from neurad_tpu_torch.pipelines import splatad_pipeline as TP
from neurad_tpu_torch.scripts import closed_loop as TCL
from neurad_tpu_torch.scripts import train as TTrain

from test_torch_splatad import DECODED, SCENE, SMALL

torch.set_num_threads(1)

MODEL = dict(SMALL, num_downscales=0)
MCMC = dict(cap_max=3000, refine_start_iter=2, refine_every=4)
CAP = 3000
GRAD_OF_MAX, GRAD_RTOL = 2e-4, 1e-3


def _pipelines(fp32: bool):
    jp = JPipe(JSynth(**SCENE).setup().get_dataparser_outputs(),
               JPipeCfg(model=JS.SplatADConfig(**MODEL), mcmc=JMCMC(**MCMC), cap_max=CAP,
                        datamanager=JDMC(max_lidar_points=4096)))
    tp = TP.SplatADPipeline(
        TSynth(**SCENE).setup().get_dataparser_outputs(),
        TP.SplatADPipelineConfig(model=TS.SplatADConfig(**MODEL), mcmc=TMCMC(**MCMC), cap_max=CAP,
                                 datamanager=TDMC(max_lidar_points=4096)),
        device="cpu")
    if fp32:
        for module in tp.model.modules():
            if hasattr(module, "compute_dtype"):
                module.compute_dtype = torch.float32
    jstate = jp.init_state()
    tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    return jp, jstate, tp, tp.init_state()


@pytest.fixture(scope="module")
def fp32_decoders():
    """The JAX model builds its decoders with the bf16 default and no switch;
    its module is patched so that they compute in float32 while this file's
    fp32 cases run (flax builds submodules lazily, at every apply)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "RGBDecoderCNN", functools.partial(JS.RGBDecoderCNN, compute_dtype=jnp.float32))
    mp.setattr(JS, "MLP", functools.partial(JS.MLP, compute_dtype=jnp.float32))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def run(fp32_decoders):
    """Both pipelines with fp32 decoders, walked through the file's fp32 cases
    in order (each case leaves the two in step for the next)."""
    jp, jstate, tp, tstate = _pipelines(fp32=True)
    return dict(jp=jp, jstate=jstate, tp=tp, tstate=tstate)


def _j_loss_and_grads(jp, params, s):
    """Loss, metrics and parameter gradients of the JAX pipeline for a sample,
    written as its jitted step writes them."""
    if isinstance(s, JCameraSample):
        def loss_fn(p):
            out = jp.model.apply(
                p, jnp.asarray(s.c2w), jnp.asarray(s.K), s.width, s.height, jnp.asarray(s.time),
                jnp.asarray(s.sensor_idx), jnp.asarray(s.cam_idx), cam_linear_vel=jnp.asarray(s.linear_velocity),
                rolling_shutter_time=s.rolling_shutter_time, time_to_center_pixel=s.time_to_center_pixel, train=True,
                means2d_offset=jnp.zeros((CAP, 2)), method=JS.SplatADModel.get_camera_outputs)
            return jp.model.apply(p, out, jnp.asarray(s.image), method=JS.SplatADModel.camera_loss)
    else:
        def loss_fn(p):
            out = jp.model.apply(
                p, jnp.asarray(s.l2w), jnp.asarray(s.raster_pts), jnp.asarray(s.time), jnp.asarray(s.sensor_idx),
                lidar_linear_vel=jnp.asarray(s.linear_velocity), train=True, method=JS.SplatADModel.get_lidar_outputs)
            return jp.model.apply(p, out, jnp.asarray(s.raster_pts), jnp.asarray(s.did_return), jnp.asarray(s.valid),
                                  method=JS.SplatADModel.lidar_loss)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _t_loss_and_grads(tp, s):
    model = tp.model
    model.train()
    model.zero_grad()
    if isinstance(s, TCameraSample):
        out = model.get_camera_outputs(s.c2w, s.K, s.width, s.height, s.time, s.sensor_idx, s.cam_idx,
                                       cam_linear_vel=s.linear_velocity, rolling_shutter_time=s.rolling_shutter_time,
                                       time_to_center_pixel=s.time_to_center_pixel)
        total, metrics = model.camera_loss(out, s.image)
    else:
        out = model.get_lidar_outputs(s.l2w, s.raster_pts, s.time, s.sensor_idx, lidar_linear_vel=s.linear_velocity)
        total, metrics = model.lidar_loss(out, s.raster_pts, s.did_return, s.valid)
    total.backward()
    model.eval()
    grads = {n: (p.grad.clone() if p.grad is not None else None) for n, p in model.named_parameters()}
    model.zero_grad()
    return float(total.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


COUNTS = ("ray_drop_accuracy", "depth_median_l2", "binning_dropped_pairs", "binning_cropped_gaussians",
          "points_overflowed")


def _assert_metrics(t_loss, t_metrics, j_loss, j_metrics, rtol):
    np.testing.assert_allclose(t_loss, j_loss, rtol=rtol)
    assert t_metrics.keys() == j_metrics.keys()
    for k, want in j_metrics.items():
        np.testing.assert_allclose(t_metrics[k], want, rtol=max(rtol, 5e-4) if k in COUNTS else rtol, atol=1e-6,
                                   err_msg=k)


def _assert_grads(t_grads, j_grads):
    """Every parameter's gradient; a parameter the step does not reach has a
    zero gradient in JAX and none (or zero) in the port."""
    j_grads = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, j_grads))
    assert j_grads.keys() == t_grads.keys()
    reached = 0
    for name, want in j_grads.items():
        want = want.numpy()
        scale = float(np.abs(want).max())
        got = t_grads[name]
        if got is None:
            assert scale == 0.0, f"{name}: JAX has a gradient, the port none"
            continue
        assert np.isfinite(got.numpy()).all(), name
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_OF_MAX * scale + 1e-12, rtol=GRAD_RTOL, err_msg=name)
        reached += scale > 0
    return reached


def _lr_of(tstate, name, step):
    return tstate.optimizers.schedules[tstate.optimizers.labels[name]](step)


def _assert_updated(tp, tstate, jstate, old, j_grads, step):
    j_new = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    j_grads = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, j_grads))
    for name, p in tp.model.named_parameters():
        lr = _lr_of(tstate, name, step)
        got, want, g = p.detach().numpy(), j_new[name].numpy(), np.abs(j_grads[name].numpy())
        firm = g > 1e-3 * max(float(g.max()), 1e-30)
        diff = np.abs(got - want)
        assert diff[firm].max(initial=0.0) <= 1e-3 * lr + 1e-6 * np.abs(want[firm]).max(initial=0.0), name
        assert diff.max(initial=0.0) <= 2.001 * lr + 1e-6 * np.abs(want).max(initial=0.0), name
        moved = np.abs(got - old[name].numpy()).max(initial=0.0)
        if firm.any() and lr > 1e-7:
            assert moved > 0.5 * lr, f"{name} moved by about its learning rate"


def _assert_moments(tstate, tp, jstate):
    """optax's Adam moments against torch.optim's, carried across by the same
    bridge as the parameters (a group's optax state masks the other groups'
    leaves; zeros stand in for them)."""
    import optax

    masked = lambda x: isinstance(x, optax.MaskedNode)
    torch_params = dict(tp.model.named_parameters())
    for group, opt in tstate.optimizers.optimizers.items():
        adam = next(s for s in jax.tree.leaves(jstate.opt_state.inner_states[group], is_leaf=lambda x: hasattr(x, "mu"))
                    if hasattr(s, "mu"))
        names = [n for n, g in tstate.optimizers.labels.items() if g == group]
        for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            tree = jax.tree.map(lambda m, p: np.zeros_like(p) if masked(m) else np.asarray(m), theirs, jstate.params,
                                is_leaf=masked)
            want = bridge.splatad_params_from_flax(tree)
            for name in names:
                scale = float(want[name].abs().max())
                np.testing.assert_allclose(opt.state[torch_params[name]][ours].numpy(), want[name].numpy(),
                                           atol=2 * GRAD_OF_MAX * scale + 1e-20, rtol=2 * GRAD_RTOL,
                                           err_msg=f"{name}.{ours}")
        assert {int(opt.state[torch_params[n]]["step"]) for n in names} == {int(adam.count)}


def _samples(run, want_camera: bool):
    """The next sample of the wanted kind, the same one on both sides."""
    while True:
        js, ts = run["jp"].datamanager.next_train(), run["tp"].datamanager.next_train()
        assert type(js).__name__ == type(ts).__name__
        if isinstance(ts, TCameraSample) == want_camera:
            assert getattr(js, "cam_idx", None) == getattr(ts, "cam_idx", None)
            assert getattr(js, "scan_idx", None) == getattr(ts, "scan_idx", None)
            return js, ts


@pytest.mark.parametrize("camera", [True, False], ids=["camera", "lidar"])
def test_one_step_matches_jax(run, camera):
    jp, tp, tstate = run["jp"], run["tp"], run["tstate"]
    js, ts = _samples(run, camera)
    step = tstate.step
    j_loss, j_metrics, j_grads = _j_loss_and_grads(jp, run["jstate"].params, js)
    t_loss, t_metrics, t_grads = _t_loss_and_grads(tp, ts)
    _assert_metrics(t_loss, t_metrics, j_loss, j_metrics, rtol=2e-5)
    assert _assert_grads(t_grads, j_grads) >= 12, "gaussians, actors, decoder and embedding all reached"
    # a camera step gives the lidar decoder no gradient, and the other way round
    other = next(n for n in t_grads if n.startswith("lidar_decoder." if camera else "rgb_decoder.head"))
    assert t_grads[other] is None or float(t_grads[other].abs().max()) == 0.0

    old = {n: p.detach().clone() for n, p in tp.model.named_parameters()}
    run["jstate"], j_step_metrics = jp.train_step(run["jstate"], js)
    tstate, t_step_metrics = tp.train_step(tstate, ts)
    assert tstate.step == int(run["jstate"].step) == step + 1 and tstate.optimizers.count == step + 1
    assert not tp.model.training
    np.testing.assert_allclose(float(t_step_metrics["total_loss"]), float(j_step_metrics["total_loss"]), rtol=2e-5)
    assert t_step_metrics.keys() == j_step_metrics.keys()
    _assert_updated(tp, tstate, run["jstate"], old, j_grads, step)
    # the decoder the step did not reach was updated all the same: its Adam count advanced with the others
    # (its decay, lr * 1e-6 * p, is below an fp32 ulp of p on both sides)
    opt = tstate.optimizers.optimizers["fields"]
    assert {int(s["step"]) for s in opt.state.values()} == {step + 1}
    assert other in tstate.optimizers.labels and tstate.optimizers.labels[other] == "fields"
    _assert_moments(tstate, tp, run["jstate"])


def test_refine_matches_jax_with_shared_draws(run):
    """`_refine` (MCMC relocation + noise) with the JAX pipeline's own draws."""
    jp, tp, tstate, jstate = run["jp"], run["tp"], run["tstate"], run["jstate"]
    assert tstate.step == 2
    # make a tenth of the gaussians dead on both sides, so that the relocation has work
    dead = np.random.default_rng(0).permutation(CAP)[: CAP // 10]
    p = dict(jstate.params["params"])
    p["opacities"] = p["opacities"].at[dead].set(-8.0)
    run["jstate"] = jstate = jstate.replace(params={**jstate.params, "params": p})
    # carry JAX's parameters across again: after two Adam updates the two sides differ by up to ~2 lr in
    # entries whose gradient is rounding noise, and this case is about the refine alone
    tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    # the draws `_refine` and the strategy make from the state's key
    _, r1, r2 = jax.random.split(jstate.rng, 3)
    op = jax.nn.sigmoid(p["opacities"])
    probs = jnp.where(op < jp.config.mcmc.min_opacity, 0.0, op)
    probs = probs / jnp.clip(probs.sum(), 1e-12, None)
    targets = np.array(jax.random.choice(jax.random.split(r1)[0], CAP, shape=(CAP,), p=probs))
    eps = np.array(jax.random.normal(r2, (CAP, 3)))

    old_means = tp.model.means.detach().clone()
    run["jstate"] = jstate = jp._refine(jstate)
    tp._refine(tstate, targets=torch.from_numpy(targets), eps=torch.from_numpy(eps))
    want = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name in TP.GAUSSIAN_KEYS:
        # 2e-4: the relocation's binomial sum alternates in sign (see tests/test_torch_strategy.py)
        np.testing.assert_allclose(getattr(tp.model, name).detach().numpy(), want[name].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=name)
    assert float((tp.model.means.detach() - old_means)[torch.from_numpy(dead)].abs().max()) > 0.1, "dead slots moved"
    assert float(torch.sigmoid(tp.model.opacities.detach()).min()) >= 0.005 - 1e-6, "no dead gaussian is left"


def test_twenty_alternating_steps_track_jax(run):
    """Camera and lidar steps in turn, refines included (each side drawing its
    own relocation targets and noise from here on): the losses of both kinds
    fall, and the port's stay within 3% of JAX's at every step."""
    jp, tp = run["jp"], run["tp"]
    j_losses, t_losses, refines = [], [], 0
    for i in range(20):
        js, ts = _samples(run, i % 2 == 0)
        run["jstate"], jm = jp.train_step(run["jstate"], js)
        before = tp.model.means.detach().clone()
        run["tstate"], tm = tp.train_step(run["tstate"], ts)
        refines += TP.should_refine(run["tstate"].step, tp.config.mcmc)
        key = "main_loss" if i % 2 == 0 else "depth_loss"
        j_losses.append(float(jm[key]))
        t_losses.append(float(tm[key]))
        assert np.isfinite(float(tm["total_loss"])) and float((tp.model.means.detach() - before).abs().max()) > 0
    assert run["tstate"].step == int(run["jstate"].step) == 22 and refines == 5
    np.testing.assert_allclose(t_losses, j_losses, rtol=3e-2)
    cam, lid = t_losses[0::2], t_losses[1::2]
    assert np.mean(cam[-3:]) < np.mean(cam[:3]) and np.mean(lid[-3:]) < np.mean(lid[:3])


def test_checkpoint_round_trip(run, tmp_path):
    """Save, load into a fresh pipeline, and the next steps (a refine among
    them) are identical: model, optimizer moments, step, generator, sampler."""
    tp, tstate = run["tp"], run["tstate"]
    path = tp.save_checkpoint(tstate, tmp_path / "checkpoints")
    assert path.name == f"step-{tstate.step:09d}.pt"
    fresh = TP.SplatADPipeline(tp.outputs, tp.config, device="cpu")
    for module in fresh.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    fstate = fresh.load_checkpoint(tmp_path / "checkpoints", fresh.init_state())
    assert fstate.step == tstate.step and fstate.optimizers.count == tstate.optimizers.count
    refined = False
    for _ in range(3):
        a, b = tp.datamanager.next_train(), fresh.datamanager.next_train()
        assert type(a) is type(b) and getattr(a, "cam_idx", None) == getattr(b, "cam_idx", None)
        tstate, m1 = tp.train_step(tstate, a)
        fstate, m2 = fresh.train_step(fstate, b)
        refined |= TP.should_refine(tstate.step, tp.config.mcmc)
        for k in m1:
            assert float(m1[k]) == float(m2[k]), k
    assert refined
    for (name, p), q in zip(tp.model.named_parameters(), fresh.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)
    run["tstate"] = tstate
    with pytest.raises(FileNotFoundError):
        tp.load_checkpoint(tmp_path / "nowhere")


def test_downscale_schedule_and_config_round_trip():
    cfg = TP.SplatADPipelineConfig(model=TS.SplatADConfig(num_downscales=2, resolution_schedule=10), cap_max=500)
    assert TP.SplatADPipelineConfig.from_dict(json.loads(json.dumps(cfg.to_dict()))) == cfg
    outputs = TSynth(num_frames=2, image_height=32, image_width=48).setup().get_dataparser_outputs()
    tp = TP.SplatADPipeline(outputs, cfg, device="cpu")
    jp = JPipe(JSynth(num_frames=2, image_height=32, image_width=48).setup().get_dataparser_outputs(),
               JPipeCfg(model=JS.SplatADConfig(num_downscales=2, resolution_schedule=10), cap_max=500))
    for step, factor in ((0, 4), (9, 4), (10, 2), (25, 1)):
        t, j = tp._downscale_sample(tp.datamanager._camera_sample(0), step), jp._downscale_sample(
            jp.datamanager._camera_sample(0), step)
        assert (t.height, t.width) == (j.height, j.width) == (32 // factor, 48 // factor)
        np.testing.assert_array_equal(t.K, j.K)
        np.testing.assert_array_equal(t.image, j.image)
    with pytest.raises(TypeError, match="CameraSample or a LidarSample"):
        tp.train_step(tp.init_state(), object())


def test_default_strategy_steps_and_refines():
    """The Default (absgrad) strategy through `train_step`: the screen-space
    gradient sums accumulate on camera steps only, a refine grows and prunes at
    fixed capacity and starts the sums anew, an opacity reset clamps."""
    from neurad_tpu_torch.model_components.strategy import DefaultStrategyConfig, alive_mask

    outputs = TSynth(num_frames=3, image_height=32, image_width=48).setup().get_dataparser_outputs()
    cfg = TP.SplatADPipelineConfig(
        strategy="default", cap_max=800, datamanager=TDMC(max_lidar_points=512),
        model=TS.SplatADConfig(num_downscales=0, max_per_tile=64, lidar_max_per_tile=32),
        default_strategy=DefaultStrategyConfig(refine_start_iter=1, refine_every=3, reset_every=4, grow_grad2d=1e-7,
                                               max_grow_per_refine=64))
    tp = TP.SplatADPipeline(outputs, cfg, device="cpu")
    with torch.no_grad():  # free capacity for the grow
        tp.model.scales[:100] = -20.0
        tp.model.opacities[:100] = -15.0
    state = tp.init_state()
    cam, lid = tp.datamanager._camera_sample(0), tp.datamanager._lidar_sample(0)
    state, _ = tp.train_step(state, cam)
    visible = int(tp._count.sum())
    assert visible > 0 and float(tp._grad2d_sum.max()) > 0
    state, _ = tp.train_step(state, lid)
    assert int(tp._count.sum()) == visible, "a lidar step adds nothing to the sums"
    alive_before = int(alive_mask(tp._gaussians()).sum())
    state, _ = tp.train_step(state, cam)  # step 3: refine
    assert int(tp._count.sum()) == 0 and float(tp._grad2d_sum.max()) == 0
    assert int(alive_mask(tp._gaussians()).sum()) > alive_before, "grown into the free slots"
    state, _ = tp.train_step(state, cam)  # step 4: opacity reset
    live = alive_mask(tp._gaussians())
    assert float(torch.sigmoid(tp.model.opacities.detach()[live]).max()) <= 0.01 + 1e-6
    assert tp.model.means.shape[0] == 800


def test_default_strategy_step_and_refine_match_jax(fp32_decoders):
    """The Default strategy through both pipelines: a camera step's running
    sums (the screen-space gradient norm of every visible gaussian, scaled by
    half the image size, and the visibility count), `_refine_default` with the
    JAX pipeline's draws handed to both, and the opacity reset that
    `_maybe_refine` makes when it is due. The sums are held like gradients
    (2e-4 of the largest entry plus 1e-3 relative), the counts exactly."""
    from neurad_tpu.model_components.strategy import DefaultStrategyConfig as JDefault
    from neurad_tpu_torch.model_components.strategy import DefaultStrategyConfig as TDefault

    strategy = dict(refine_start_iter=1, refine_every=3, reset_every=4, grow_grad2d=1e-7, max_grow_per_refine=64)
    jp = JPipe(JSynth(**SCENE).setup().get_dataparser_outputs(),
               JPipeCfg(model=JS.SplatADConfig(**MODEL), strategy="default", default_strategy=JDefault(**strategy),
                        cap_max=CAP, datamanager=JDMC(max_lidar_points=4096)))
    tp = TP.SplatADPipeline(
        TSynth(**SCENE).setup().get_dataparser_outputs(),
        TP.SplatADPipelineConfig(model=TS.SplatADConfig(**MODEL), strategy="default",
                                 default_strategy=TDefault(**strategy), cap_max=CAP,
                                 datamanager=TDMC(max_lidar_points=4096)),
        device="cpu")
    for module in tp.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    jstate, tstate = jp.init_state(), tp.init_state()
    # a tenth of the slots free on both sides, so that the refine can grow into them
    dead = np.random.default_rng(1).permutation(CAP)[: CAP // 10]
    p = dict(jstate.params["params"])
    p["scales"] = p["scales"].at[dead].set(-20.0)
    p["opacities"] = p["opacities"].at[dead].set(-15.0)
    jstate = jstate.replace(params={**jstate.params, "params": p})
    carry = lambda: tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    carry()
    alive_before = np.array(p["scales"]).max(-1) > -10  # (the JAX step donates its state's arrays)

    jstate, _ = jp.train_step(jstate, jp.datamanager._camera_sample(1))
    tstate, _ = tp.train_step(tstate, tp.datamanager._camera_sample(1))
    want_sum, want_count = np.asarray(jp._grad2d_sum), np.asarray(jp._count)
    assert 100 < want_count.sum() < CAP - len(dead) + 1 and want_sum.max() > 0
    np.testing.assert_array_equal(tp._count.numpy(), want_count)
    np.testing.assert_allclose(tp._grad2d_sum.numpy(), want_sum, atol=GRAD_OF_MAX * want_sum.max(), rtol=GRAD_RTOL)
    # a lidar step adds nothing to the sums on either side
    jstate, _ = jp.train_step(jstate, jp.datamanager._lidar_sample(1))
    tstate, _ = tp.train_step(tstate, tp.datamanager._lidar_sample(1))
    np.testing.assert_array_equal(np.asarray(jp._count), want_count)
    np.testing.assert_array_equal(tp._count.numpy(), want_count)

    # the refine alone: JAX's parameters and sums carried across (two Adam updates leave the sides up to ~2 lr
    # apart), and the draws `_refine_default` and `default_refine` make from the state's key handed to the port
    carry()
    tp._grad2d_sum = torch.from_numpy(np.array(jp._grad2d_sum))
    _, r = jax.random.split(jstate.rng)
    rng_a, r_keep = jax.random.split(r)
    keep_u = np.array(jax.random.uniform(r_keep, (CAP,)))
    _, r1, r2 = jax.random.split(rng_a, 3)
    split_eps = tuple(torch.from_numpy(np.array(jax.random.normal(k, (64, 3)))) for k in (r1, r2))
    jstate = jp._refine_default(jstate)
    tp._refine_default(tstate, keep_u=torch.from_numpy(keep_u), split_eps=split_eps)
    want = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name in TP.GAUSSIAN_KEYS:
        np.testing.assert_allclose(getattr(tp.model, name).detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    alive_after = tp.model.scales.detach().numpy().max(-1) > -10
    assert (~alive_before & alive_after).sum() > 20, "grown into free slots"
    assert float(np.asarray(jp._grad2d_sum).max()) == float(tp._grad2d_sum.max()) == 0.0
    assert int(np.asarray(jp._count).sum()) == int(tp._count.sum()) == 0

    # step 4: no refine is due, the opacity reset is
    jstate = jp._maybe_refine(jstate.replace(step=jnp.asarray(4, jnp.int32)))
    tstate.step = 4
    tp._maybe_refine(tstate)
    want = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    np.testing.assert_allclose(tp.model.opacities.detach().numpy(), want["opacities"].numpy(), rtol=1e-6, atol=1e-6)
    assert float(torch.sigmoid(tp.model.opacities.detach()[torch.from_numpy(alive_after)]).max()) <= 0.01 + 1e-6
    np.testing.assert_array_equal(tp.model.scales.detach().numpy(), want["scales"].numpy())


def test_bf16_default_steps_match_jax():
    """One camera and one lidar step with the bf16 decoders both sides default
    to: the losses inherit the decoders' `DECODED` tolerance."""
    jp, jstate, tp, tstate = _pipelines(fp32=False)
    for js, ts in ((jp.datamanager._camera_sample(1), tp.datamanager._camera_sample(1)),
                   (jp.datamanager._lidar_sample(1), tp.datamanager._lidar_sample(1))):
        jstate, jm = jp.train_step(jstate, js)
        tstate, tm = tp.train_step(tstate, ts)
        assert tm.keys() == jm.keys()
        for k in jm:
            if k not in COUNTS and k != "psnr":
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=DECODED, rtol=DECODED, err_msg=k)
    want = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tp.model.named_parameters():
        bound = 2.001 * 2 * max(_lr_of(tstate, name, 0), _lr_of(tstate, name, 1))  # two updates of about lr each
        assert float((p.detach() - want[name]).abs().max()) <= bound + 1e-6 * float(want[name].abs().max()), name


def test_train_script_and_closed_loop_from_run_dir(tmp_path):
    argv = ["splatad-tiny", "--device", "cpu", "--output-dir", str(tmp_path), "--experiment-name", "run",
            "--set", "trainer.steps_per_log=2", "--set", "pipeline.model.max_per_tile=32", "--dp-set", "num_frames=4"]
    pipeline, state = TTrain.entrypoint(argv + ["--max-iterations", "4"])
    assert state.step == 4 and pipeline.config.model.max_per_tile == 32
    assert sorted(p.name for p in (tmp_path / "run" / "checkpoints").glob("*.pt")) == ["step-000000004.pt"]
    assert json.loads((tmp_path / "run" / "config.json").read_text())["dataparser_config"]["num_frames"] == 4

    # resume: continues from step 4 with the sampler where it stopped, as an uninterrupted run does
    resumed, rstate = TTrain.entrypoint(["splatad-tiny", "--device", "cpu", "--load-dir", str(tmp_path / "run"),
                                         "--max-iterations", "6"])
    straight, sstate = TTrain.entrypoint([*argv[:6], "straight", *argv[7:], "--max-iterations", "6"])
    assert rstate.step == sstate.step == 6
    for (name, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)

    # the closed-loop server state of the run renders what the run's pipeline renders
    served = TCL.ClosedLoopState.from_run_dir(tmp_path / "run", device="cpu")
    assert served.pipeline.config == resumed.config and served.pipeline.device.type == "cpu"
    pose = np.eye(4, dtype=np.float32)
    pose[:3] = resumed.outputs.cameras.camera_to_worlds[1].numpy()
    pose[:3, 3] += pose[:3, 0] * 0.7
    want = TCL.ClosedLoopState(resumed, device="cpu").render_image(pose.tolist(), 1.1, "front_camera")
    np.testing.assert_array_equal(served.render_image(pose.tolist(), 1.1, "front_camera"), want)
    with pytest.raises(SystemExit):
        TTrain.entrypoint(["neurad", "--device", "cpu"])
