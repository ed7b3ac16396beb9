"""The plain reference held against an independent witness: the JAX package,
on the CPU, at small widths.

`portbench/reference/port/` is a frozen copy of the port's modules with its
kernels replaced by their plain versions, so a fault that the port had when
the copy was made would be in the reference too. These tests hold the
reference, as the benchmark drives it, against the JAX package, which the
port was ported from and which shares no code with it, on the same inputs:
parameters carried across by `neurad_tpu_torch.params_from_jax` (a test
helper here; the reference itself imports nothing of the port), the same
scene, the same requests and the same batch draws.

- NeuRAD serving (`NeuRADServe.render`): a closed-loop request at a moved
  pose after the actors were moved, against the JAX package's
  `ClosedLoopState.render_image` after its `update_actors`: ray generation,
  hash-grid proposal sampling, the field, SDF rendering and the decoder.
- NeuRAD training (`NeuRADTrain.step`): the batch that the reference draws
  again from the sampler's state (rays and targets from its own scene), the
  loss with every term and the VGG19 loss, its gradients, and three steps of
  Adam over the parameter groups, against the JAX package's batch,
  `loss_fn`, gradients and optax update.
- SplatAD serving (`SplatADServe.render`): projection, binning, the camera
  composite and the decoder, with the actor moved, against the JAX
  package's closed loop.

The benchmark never runs this file (it imports JAX); it is the witness that
the reference is right, run with `python3 -m pytest portbench/tests` on a
machine with the JAX package.

Tolerances. NeuRAD runs fp32 end to end on both sides (`compute_fp32`), so
rgb is held to 5e-4 on 99% of the values and 5e-3 everywhere, as the port is
held in `tests/test_torch_neurad.py` (a resampled sample can move by an ulp
across a cell face); the first loss to 2e-6 relative and the next two to
3e-4; every gradient within 2e-5 of its parameter's largest entry (both
sides sum the same fp32 terms in other orders); after three steps every
entry within 2 lr a step of JAX's and at most 1% of the entries more than
0.1 lr apart (Adam's first updates are about lr * sign(g)). SplatAD's
accumulation and depth are fp32 on both sides (1e-5); its decoder runs in
bf16 on both sides, and XLA and torch round bf16 convolutions at different
points, so rgb is held to 2e-2.
"""

from __future__ import annotations

import copy
import math
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neurad_tpu.data.datamanager import ADDataManagerConfig as JDMC  # noqa: E402
from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth  # noqa: E402
from neurad_tpu.engine import optimizers as JO  # noqa: E402
from neurad_tpu.fields import neurad_encoding as JE  # noqa: E402
from neurad_tpu.models import neurad as JM  # noqa: E402
from neurad_tpu.models import splatad as JS  # noqa: E402
from neurad_tpu.pipelines.ad_pipeline import ADPipeline as JPipe  # noqa: E402
from neurad_tpu.pipelines.ad_pipeline import ADPipelineConfig as JPipeCfg  # noqa: E402
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipeline as JSPipe  # noqa: E402
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipelineConfig as JSPipeCfg  # noqa: E402
from neurad_tpu.scripts import closed_loop as JCL  # noqa: E402
from neurad_tpu_torch import params_from_jax as bridge  # noqa: E402

from portbench.families.neurad import model_overrides  # noqa: E402
from portbench.reference.neurad_serve import NeuRADServe  # noqa: E402
from portbench.reference.neurad_train import NeuRADTrain  # noqa: E402
from portbench.reference.port.data.dataparsers.synthetic import SyntheticDataParserConfig as RSynth  # noqa: E402
from portbench.reference.port.fields import neurad_encoding as RE  # noqa: E402
from portbench.reference.port.models import neurad as RM  # noqa: E402
from portbench.reference.splatad_serve import SplatADServe  # noqa: E402
from portbench.tests.by_family import neurad as tiny_neurad  # noqa: E402

torch.set_num_threads(1)

SCENE = dict(num_frames=3, image_height=36, image_width=48, lidar_channels=8, lidar_azimuths=60)
BATCH = dict(num_cam_patches=2, patch_size=4, num_lidar_rays=64)  # 32 camera rays and 64 lidar rays
CHUNK = 40  # rays a training chunk: three chunks, the last padded
EVAL_CHUNK = 128  # 12 x 16 = 192 served rays: two chunks, the second padded
LR = 5e-3
GROUPS = {g: dict(lr=LR, warmup_steps=0) for g in ("fields", "hashgrids", "cnn")} | {
    g: dict(lr=1e-4, warmup_steps=0) for g in ("trajectory_opt", "camera_opt")}


def _model_block() -> dict:
    """The tiny cells' model settings (parity layout, hash proposals, fp32)."""
    return copy.deepcopy(tiny_neurad.NEURAD_MODEL)


def _jax_overrides(block: dict) -> dict:
    """The same settings as the JAX package's model overrides."""
    return model_overrides(block, JE, JM)


def _outputs(synth):
    out = synth(**SCENE).setup().get_dataparser_outputs()
    traj = out.trajectories[0]  # the actor rides 1.5 m ahead of the ego vehicle (which drives +x at 2 m/s)
    stamps = np.asarray(traj["timestamps"])
    traj["poses"] = np.array(traj["poses"])
    traj["poses"][:, :3, 3] = np.stack([2.0 * stamps + 1.5, np.full(len(stamps), 0.1), np.full(len(stamps), 1.5)], -1)
    traj["dims"] = np.array([1.2, 1.2, 1.2], np.float32)
    return out


def _livened(tree):
    """The JAX parameters with every hash table x 300 and the SDF bias at 0.08
    (at JAX's initial 1e-3 tables the picture would not depend on the grids)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (tuple(np.asarray(t) * 300.0 for t in v) if k.endswith("hash_table") else walk(v))
                    for k, v in node.items()}
        return np.asarray(node)
    out = walk(jax.tree.map(np.asarray, tree))
    bias = np.array(out["params"]["field"]["mlp_geo"]["output"]["bias"])
    bias[0] = 0.08
    out["params"]["field"]["mlp_geo"]["output"]["bias"] = bias
    return out


def _carried(tree, module: torch.nn.Module) -> dict:
    """The JAX tree's values under the reference model's parameter names."""
    names = {n for n, _ in module.named_parameters()}
    return {k: v for k, v in bridge.neurad_params_from_flax(tree, module.state_dict()).items() if k in names}


def _check_rgb(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert float(err.max()) <= 5e-3, float(err.max())
    assert float(np.quantile(err, 0.99)) <= 5e-4, float(np.quantile(err, 0.99))


# ----------------------------------------------------------------------
# NeuRAD serving
# ----------------------------------------------------------------------


def test_neurad_serve_reference_matches_jax_after_an_actor_update():
    block = _model_block()
    block.pop("loss")
    jout, rout = _outputs(JSynth), _outputs(RSynth)
    jcfg = JPipeCfg(datamanager=JDMC(**BATCH), eval_chunk=EVAL_CHUNK, eval_shard=False,
                    model_overrides=dict(_jax_overrides(block), loss=JM.LossSettings(vgg_mult=0.0)))
    jp = JPipe(jout, jcfg)
    state, _ = jp.init_state()
    tree = _livened(state.params)
    state = state.replace(params=jax.tree.map(jnp.asarray, tree))
    jstate = JCL.ClosedLoopState.__new__(JCL.ClosedLoopState)  # the JAX server loads a run directory; by hand
    jstate.pipeline, jstate.state, jstate.render_lock, jstate.time_offset = jp, state, threading.Lock(), 0.0

    serve = {"eval_chunk": EVAL_CHUNK, "rgb_upsample_factor": 3}
    overrides = model_overrides(block, RE, RM)
    shell = NeuRADServe(serve, rout, {}, "cpu", model=overrides)
    ref = NeuRADServe(serve, rout, _carried(tree, shell.model), "cpu", model=overrides)

    pose = np.eye(4, dtype=np.float32)
    pose[:3] = np.asarray(jout.cameras.camera_to_worlds[0])
    pose[:3, 3] += pose[:3, 0] * 1.0 + pose[:3, 1] * 0.3
    actors = jstate.get_actors()
    moved = np.asarray(actors[0]["poses"], np.float32)
    moved[:, 1, 3] += 0.4  # across, and 1.5 m nearer: 1.6 m ahead at t = 0.8, where the samples are
    moved[:, 0, 3] -= 1.5
    actors[0]["poses"] = moved.tolist()
    before = ref.render(pose, 0.8, "front_camera", jstate.get_actors())
    jstate.update_actors(actors)
    want = np.asarray(jstate.render_image(pose.tolist(), 0.8, "front_camera"))
    got = ref.render(pose, 0.8, "front_camera", actors)
    _check_rgb(got, want)
    assert float(np.abs(got - before).max()) > 1e-3, "the moved actor shows"


# ----------------------------------------------------------------------
# NeuRAD training
# ----------------------------------------------------------------------


def _jax_draws(key, n_rays: int, chunk: int) -> list:
    """The JAX package's jitters and flips for one step key, as the
    reference's `draw` returns them: [(jitters per round, flip)] a chunk."""
    if chunk and n_rays > chunk:
        keys, sizes = jax.random.split(key, math.ceil(n_rays / chunk)), [chunk] * math.ceil(n_rays / chunk)
    else:
        keys, sizes = [key], [n_rays]
    out = []
    for k, r in zip(keys, sizes):
        samp, flip = jax.random.split(k)
        rounds = jax.random.split(samp, 3)  # two proposal rounds and the field's
        jitters = tuple(torch.from_numpy(np.array(jax.random.uniform(lk, (r, 1)))) for lk in rounds)
        out.append((jitters, torch.from_numpy(np.array(jax.random.uniform(flip, (r,))))))
    return out


@pytest.fixture(scope="module")
def trained():
    """Three steps of the JAX package and of the reference from the same
    parameters and sampler state: (JAX losses, reference losses, JAX first
    gradients and the reference's as Adam got them, JAX and reference
    parameters after the steps, the reference)."""
    block = _model_block()
    jout, rout = _outputs(JSynth), _outputs(RSynth)
    groups = {k: JO.OptimizerGroupConfig(**v) for k, v in GROUPS.items()}
    jp = JPipe(jout, JPipeCfg(datamanager=JDMC(**BATCH), eval_shard=False, train_ray_chunk=CHUNK,
                              model_overrides=_jax_overrides(block), optimizer_groups=groups))
    state, tx = jp.init_state()
    tree = _livened(state.params)
    state = state.replace(params=jax.tree.map(jnp.asarray, tree))
    assert jp.vgg_params is not None

    train = dict(BATCH, rgb_upsample_factor=3, train_ray_chunk=CHUNK, optimizer_groups=GROUPS)
    overrides = model_overrides(block, RE, RM)
    shell = NeuRADTrain(train, rout, {}, "cpu", model=overrides)
    ref = NeuRADTrain(train, rout, _carried(tree, shell.model), "cpu", model=overrides)
    ref.vgg.load_state_dict(bridge.vgg_params_from_flax(jax.tree.map(np.asarray, jp.vgg_params)))

    vg = jax.jit(jax.value_and_grad(jp.loss_fn, has_aux=True))
    update = jax.jit(tx.update)
    jlosses, rlosses, jgrads, rgrads = [], [], None, None
    for step in range(3):
        sampler_state = copy.deepcopy(jp.datamanager.rng_state())
        jb, jbatch = jp.datamanager.next_train()
        rng, step_rng = jax.random.split(state.rng)
        (jloss, _), grads = vg(state.params, jb, jbatch, step_rng)
        updates, opt_state = update(grads, state.opt_state, state.params)
        state = state.replace(params=optax.apply_updates(state.params, updates), opt_state=opt_state, rng=rng)
        jlosses.append(float(jloss))
        rlosses.append(ref.step(sampler_state, draws=_jax_draws(step_rng, jb.origins.shape[0], CHUNK)))
        if step == 0:
            jgrads = bridge.neurad_params_from_flax(jax.tree.map(np.asarray, grads), ref.model.state_dict())
            rgrads = ref.first_moments()
    jparams = bridge.neurad_params_from_flax(jax.tree.map(np.asarray, state.params), ref.model.state_dict())
    return dict(jlosses=jlosses, rlosses=rlosses, jgrads=jgrads, rgrads=rgrads, jparams=jparams, ref=ref)


def test_neurad_train_reference_losses_match_jax(trained):
    j, r = trained["jlosses"], trained["rlosses"]
    assert abs(r[0] - j[0]) <= 2e-6 * abs(j[0]), (r, j)
    for a, b in zip(r[1:], j[1:]):
        assert abs(a - b) <= 3e-4 * abs(b), (r, j)


def test_neurad_train_reference_gradients_match_jax(trained):
    want, got = trained["jgrads"], trained["rgrads"]
    moved = 0
    for name, p in trained["ref"].model.named_parameters():
        g = got.get(name, torch.zeros_like(p))
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= 2e-5 * scale + 1e-8, (name, err, scale)
        moved += scale > 0
    assert moved >= 20


def test_neurad_train_reference_adam_steps_match_jax(trained):
    ref, want = trained["ref"], trained["jparams"]
    far = total = 0
    for name, p in ref.model.named_parameters():
        lr = LR if not name.startswith(("actors.", "camera_optimizer.")) else 1e-4
        diff = (p.detach() - want[name]).abs()
        assert float(diff.max()) <= 3 * 2 * lr * (1 + 1e-5), name
        far += int((diff > 0.1 * lr).sum())
        total += diff.numel()
    assert far <= 0.01 * total, far / total


# ----------------------------------------------------------------------
# SplatAD serving
# ----------------------------------------------------------------------

SPLAT = dict(max_per_tile=256, near_plane=2.0, lidar_tile_azim=20.0, lidar_tile_elev=14.0, lidar_max_per_tile=32,
             lidar_pts_per_tile=64)


class _State:
    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _State(params)


def test_splatad_serve_reference_matches_jax_after_an_actor_update():
    from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManagerConfig as JFDMC

    scene = dict(SCENE, image_height=128, image_width=128)
    jout = JSynth(**scene).setup().get_dataparser_outputs()
    rout = RSynth(**scene).setup().get_dataparser_outputs()
    jp = JSPipe(jout, JSPipeCfg(model=JS.SplatADConfig(**SPLAT), cap_max=3000, datamanager=JFDMC(max_lidar_points=4096)))
    params = jp.model.init(jax.random.PRNGKey(0), method=JS.SplatADModel.init_all)
    jstate = JCL.ClosedLoopState.__new__(JCL.ClosedLoopState)
    jstate.pipeline, jstate.state, jstate.render_lock, jstate.time_offset = jp, _State(params), threading.Lock(), 0.0

    carried = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, params))
    ids = torch.from_numpy(np.asarray(jp.model.init_data.ids)).to(torch.int32)
    ref = SplatADServe({"cap_max": 3000, "model": SPLAT}, rout, carried, ids, "cpu")

    pose = np.eye(4, dtype=np.float32)
    pose[:3] = np.asarray(jout.cameras.camera_to_worlds[1])
    pose[:3, 3] += pose[:3, 0] * 1.5
    actors = jstate.get_actors()
    moved = np.asarray(actors[0]["poses"], np.float32)
    moved[:, 1, 3] += 1.0
    actors[0]["poses"] = moved.tolist()
    before = ref.render(pose, 2.2, "front_camera", jstate.get_actors())
    jstate.update_actors(actors)
    want = np.asarray(jstate.render_image(pose.tolist(), 2.2, "front_camera"))
    got = ref.render(pose, 2.2, "front_camera", actors)
    assert got.shape == want.shape == (128, 128, 3)
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert float(np.abs(got - before).max()) > 1e-2, "the moved actor shows"

    # the composite before the decoder, fp32 on both sides, with the moved actor (the reference holds it)
    K = np.array([[90.0, 0, 64], [0, 90.0, 64], [0, 0, 1.0]], np.float32)
    vel = np.array([2.0, 0.0, 0.0], np.float32)
    j = jp.model.apply(jstate.state.params, jnp.asarray(pose[:3]), jnp.asarray(K), 128, 128, jnp.asarray(2.2),
                       jnp.asarray(0), jnp.asarray(1), cam_linear_vel=jnp.asarray(vel), rolling_shutter_time=0.05,
                       method=JS.SplatADModel.get_camera_outputs)
    with torch.no_grad():
        r = ref.model.get_camera_outputs(pose[:3], K, 128, 128, 2.2, 0, 1, cam_linear_vel=vel,
                                         rolling_shutter_time=0.05)
    assert float(np.asarray(j["accumulation"]).max()) > 0.2
    for key in ("accumulation", "depth"):
        np.testing.assert_allclose(r[key].numpy(), np.asarray(j[key]), rtol=1e-5, atol=1e-5, err_msg=key)
