"""The NeuRAD training slice as a whole: the port's `ADPipeline` training
batches, loss, gradients, optimizer groups, steps, checkpoints and train
script against the JAX package's, at `neurad-tiny` widths on the synthetic
scene, parameters carried across by `neurad_params_from_flax` (tables scaled
by 300, the SDF bias at 0.08 and the actor 1.5 m ahead, as in
`test_torch_neurad.py`, so that geometry and actors matter).

The random draws are the JAX package's: the tests split the step's key as its
trainer (`trainer.py:103`), its chunked map (`chunking.py:50`), the model
(`neurad.py:294`) and the proposal sampler (`ray_samplers.py:239`) do, draw
the samplers' jitter (`ray_samplers.py:70, 116`) and the actor flip
(`neurad_encoding.py:305`) with `jax.random.uniform`, and hand the numbers to
the port.

Tolerances (`compute_fp32=True`: fp32 reads, MLPs and decoders on both sides).
Losses and metrics to 2e-6 relative (measured 1e-6). Gradients per tensor to
2e-5 of the tensor's largest entry, plus 1e-8 absolute: both sides compute the
same fp32 terms in other orders (measured 4e-6), except the MLP proposal
fields, whose gradients are sums of cancelling terms of 1e-7..1e-6 in all
(noise level: measured 1.5e-2 of the tensor's largest entry, 6e-9 absolute).
Three steps from the same parameters and draws: the first loss to 2e-6, the
next two to 3e-4 relative (measured 3.4e-6, 5.8e-5); every parameter entry
within 2 * lr per step (Adam's first updates are about lr * sign(g), so an
entry whose gradient is noise-level, or differs in sign, moves by up to
2 * lr), and at most 1% of all entries more than 0.1 * lr apart (measured
0.2%).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurad_tpu.data.datamanager import ADDataManagerConfig as JDMC
from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.engine import optimizers as JO
from neurad_tpu.fields import neurad_encoding as JE
from neurad_tpu.models import neurad as JM
from neurad_tpu.pipelines.ad_pipeline import ADPipeline as JPipe
from neurad_tpu.pipelines.ad_pipeline import ADPipelineConfig as JPipeCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.configs.method_configs import METHODS, neurad_tiny_overrides
from neurad_tpu_torch.data.datamanager import ADDataManagerConfig as TDMC
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.engine import optimizers as TO
from neurad_tpu_torch.fields import neurad_encoding as TE
from neurad_tpu_torch.models import neurad as TM
from neurad_tpu_torch.pipelines import ad_pipeline as TP
from neurad_tpu_torch.scripts import closed_loop as TCL
from neurad_tpu_torch.scripts import train as TTrain

torch.set_num_threads(1)

SCENE = dict(num_frames=3, image_height=36, image_width=48, lidar_channels=8, lidar_azimuths=60)
BATCH = dict(num_cam_patches=2, patch_size=4, num_lidar_rays=64)  # 32 camera rays + 64 lidar rays
CHUNK = 40  # rays per chunk of the chunked branch: three chunks, the last padded
GROUPS = dict(fields=dict(lr=5e-3, warmup_steps=0), hashgrids=dict(lr=5e-3, warmup_steps=0),
              cnn=dict(lr=5e-3, warmup_steps=0), trajectory_opt=dict(lr=1e-4, warmup_steps=0),
              camera_opt=dict(lr=1e-4, warmup_steps=0))
LOSS_RTOL = 2e-6
STEP_LOSS_RTOL = 3e-4  # after an update (measured 3.4e-6 and 5.8e-5 at the second and third step)
GRAD_TOL, GRAD_ATOL = 2e-5, 1e-8
NOISE_TOL = 5e-2  # the MLP proposal fields' noise-level gradients


def _overrides(E, M):
    prop = E.StaticSettings(num_levels=2, base_res=16, max_res=128, log2_hashmap_size=11, hashgrid_dim=1)
    return dict(
        loss=M.LossSettings(vgg_mult=0.0),
        sampling=M.SamplingSettings(num_proposal_samples=(12, 8), num_nerf_samples=6, sky_distance=1000.0),
        field_static=E.StaticSettings(num_levels=4, base_res=16, max_res=256, log2_hashmap_size=13, hashgrid_dim=4),
        field_actor=E.ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=11, hashgrid_dim=4),
        proposal_static=(prop, prop),
        proposal_actor=E.ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=9, hashgrid_dim=1),
        appearance_dim=4, max_actors_per_ray=1, compute_fp32=True,
    )


def _outputs(synth):
    out = synth(**SCENE).setup().get_dataparser_outputs()
    traj = out.trajectories[0]  # the actor rides 1.5 m ahead of the ego vehicle (which drives +x at 2 m/s)
    stamps = np.asarray(traj["timestamps"])
    traj["poses"] = np.array(traj["poses"])
    traj["poses"][:, :3, 3] = np.stack([2.0 * stamps + 1.5, np.full(len(stamps), 0.1), np.full(len(stamps), 1.5)], -1)
    traj["dims"] = np.array([1.2, 1.2, 1.2], np.float32)
    return out


def _scaled(tree):
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


_CACHE = {}


def _jax(chunk):
    """(JAX pipeline, its state with livened parameters, tx, its datamanager's
    state after init_state, the jitted value_and_grad of its loss_fn)."""
    if chunk not in _CACHE:
        cfg = JPipeCfg(datamanager=JDMC(**BATCH), eval_shard=False, train_ray_chunk=chunk,
                       model_overrides=_overrides(JE, JM),
                       optimizer_groups={k: JO.OptimizerGroupConfig(**v) for k, v in GROUPS.items()})
        jp = JPipe(_outputs(JSynth), cfg)
        state, tx = jp.init_state()
        state = state.replace(params=jax.tree.map(jnp.asarray, _scaled(state.params)))
        vg = jax.jit(jax.value_and_grad(jp.loss_fn, has_aux=True))
        _CACHE[chunk] = (jp, state, tx, jp.datamanager.rng_state(), vg)
    jp, state, tx, rng_state, vg = _CACHE[chunk]
    jp.datamanager.set_rng_state(rng_state)  # every test starts from the batch after init_state's
    return jp, state, tx, vg


def _port(jstate, chunk, **cfg):
    """The port's pipeline with the JAX state's parameters, and its training state."""
    tp = TP.ADPipeline(_outputs(TSynth), TP.ADPipelineConfig(
        datamanager=TDMC(**BATCH), train_ray_chunk=chunk, model_overrides=_overrides(TE, TM),
        optimizer_groups={k: TO.OptimizerGroupConfig(**v) for k, v in GROUPS.items()}, **cfg), device="cpu")
    res = tp.model.load_state_dict(bridge.neurad_params_from_flax(jax.tree.map(np.asarray, jstate.params),
                                                                  tp.model.state_dict()))
    assert not res.missing_keys and not res.unexpected_keys
    return tp, tp.init_state()


def _draws(key, n_rays, chunk):
    """The JAX package's draws for one step key, as the port's TrainDraws."""
    if chunk and n_rays > chunk:
        keys = jax.random.split(key, math.ceil(n_rays / chunk))
        sizes = [chunk] * keys.shape[0]
    else:
        keys, sizes = [key], [n_rays]
    draws = []
    for k, r in zip(keys, sizes):
        samp, flip = jax.random.split(k)
        level_keys = jax.random.split(samp, 3)  # two proposal rounds and the field's
        jitters = tuple(torch.from_numpy(np.array(jax.random.uniform(lk, (r, 1)))) for lk in level_keys)
        draws.append(TP.ChunkDraws(jitters, torch.from_numpy(np.array(jax.random.uniform(flip, (r,))))))
    return draws


def _close(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-6), (what, got, want)


def _same(got, want, what):
    """Integers, flags and sampled values equal; computed floats (a ray's pixel
    area is a product taken in another order) to 1e-6 relative."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


def test_next_train_gives_the_jax_batch():
    jp, jstate, _, _ = _jax(0)
    tp, _ = _port(jstate, 0)
    for _ in range(2):
        jb, jbatch = jp.datamanager.next_train()
        tb, tbatch = tp.datamanager.next_train()
        for field in ("origins", "directions", "pixel_area", "camera_indices", "nears", "fars", "times"):
            _same(getattr(tb, field), getattr(jb, field), field)
        assert set(tb.metadata) == set(jb.metadata) == {"sensor_idxs", "directions_norm", "did_return", "is_lidar"}
        for key, value in jb.metadata.items():
            _same(tb.metadata[key], value, key)
        assert set(tbatch) == set(jbatch) and tbatch["image"].shape == (2, 12, 12, 3)
        for key, value in jbatch.items():
            _same(tbatch[key], value, key)
        assert int(tb.metadata["is_lidar"].sum()) == 64 and bool(tbatch["did_return"].any())


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["whole_batch", "chunked"])
def test_loss_and_gradients_match_jax(chunk):
    jp, jstate, _, vg = _jax(chunk)
    tp, _ = _port(jstate, chunk)
    jb, jbatch = jp.datamanager.next_train()
    tb, tbatch = tp.datamanager.next_train()
    _, step_rng = jax.random.split(jstate.rng)
    (jloss, jmetrics), jgrads = vg(jstate.params, jb, jbatch, step_rng)
    draws = _draws(step_rng, tb.origins.shape[0], chunk)
    assert len(draws) == (3 if chunk else 1)
    tloss, tmetrics = tp.loss_fn(tb, tbatch, draws)
    tloss.backward()

    assert set(tmetrics) == set(jmetrics)
    assert {"rgb_loss", "depth_loss", "carving_loss_1", "interlevel_loss", "distortion_loss"} <= set(tmetrics)
    _close(tloss.detach(), jloss, LOSS_RTOL, "total")
    for key, value in jmetrics.items():
        _close(tmetrics[key], value, LOSS_RTOL, key)

    want = bridge.neurad_params_from_flax(jax.tree.map(np.asarray, jgrads), tp.model.state_dict())
    labels = TO.label_params(want, TO.DEFAULT_GROUP_RULES)
    moved = set()
    for name, p in tp.model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(want[name].abs().max())
        tol = (NOISE_TOL if name.startswith("proposal_fields") and ".mlp." in name else GRAD_TOL) * scale + GRAD_ATOL
        assert float((got - want[name]).abs().max()) <= tol, (name, float((got - want[name]).abs().max()), scale)
        if scale > 0:
            moved.add(labels[name])
    assert moved == {"fields", "hashgrids", "cnn", "trajectory_opt"}, "every group but the (disabled) camera optimizer"


def test_three_steps_match_jax():
    jp, jstate, tx, vg = _jax(0)
    tp, tstate = _port(jstate, 0)
    update = jax.jit(tx.update)
    state = jstate
    for step in range(3):
        jb, jbatch = jp.datamanager.next_train()
        tb, tbatch = tp.datamanager.next_train()
        rng, step_rng = jax.random.split(state.rng)
        (jloss, _), grads = vg(state.params, jb, jbatch, step_rng)
        updates, opt_state = update(grads, state.opt_state, state.params)
        state = state.replace(params=optax.apply_updates(state.params, updates), opt_state=opt_state, rng=rng)
        tstate, tmetrics = tp.train_step(tstate, tb, tbatch, draws=_draws(step_rng, tb.origins.shape[0], 0))
        _close(tmetrics["total_loss"], jloss, LOSS_RTOL if step == 0 else STEP_LOSS_RTOL, f"step {step} loss")
    assert tstate.step == 3 and tstate.optimizers.count == 3
    want = bridge.neurad_params_from_flax(jax.tree.map(np.asarray, state.params), tp.model.state_dict())
    lrs = tstate.optimizers.learning_rates(0)
    far = total = 0
    for name, p in tp.model.named_parameters():
        lr = lrs[tstate.optimizers.labels[name]]
        diff = (p.detach() - want[name]).abs()
        assert float(diff.max()) <= 3 * 2 * lr * (1 + 1e-5), name
        far += int((diff > 0.1 * lr).sum())
        total += diff.numel()
    assert far <= 0.01 * total, far / total


def test_optimizer_groups_match_the_jax_labels():
    """Every port parameter lands in the group of its JAX counterpart: each
    flax leaf is marked with its index, carried across by the converter, and
    the port's label compared with the JAX label of that leaf."""
    _, jstate, _, _ = _jax(0)
    tp, tstate = _port(jstate, 0)
    leaves, treedef = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, jstate.params))
    marked = jax.tree_util.tree_unflatten(treedef, [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    jlabels = jax.tree_util.tree_leaves(JO.label_params(jstate.params))
    carried = bridge.neurad_params_from_flax(marked, tp.model.state_dict())
    names = dict(tp.model.named_parameters())
    assert set(carried) == set(names)
    for name, marker in carried.items():
        assert bool((marker == marker.flatten()[0]).all())
        assert tstate.optimizers.labels[name] == jlabels[int(marker.flatten()[0])], name
    assert set(tstate.optimizers.labels.values()) == {"fields", "hashgrids", "cnn", "trajectory_opt"}
    assert TO.NEURAD_OPTIMIZER_GROUPS.keys() == JO.NEURAD_OPTIMIZER_GROUPS.keys()
    for g, cfg in TO.NEURAD_OPTIMIZER_GROUPS.items():
        assert {k: getattr(cfg, k) for k in ("lr", "lr_final", "warmup_steps", "weight_decay", "eps", "max_steps")} == {
            k: getattr(JO.NEURAD_OPTIMIZER_GROUPS[g], k)
            for k in ("lr", "lr_final", "warmup_steps", "weight_decay", "eps", "max_steps")}
    # gradient accumulation: every group falls back to the fields config here, so every group accumulates
    accum = TO.Optimizers(tp.model.named_parameters(), {"fields": TO.OptimizerGroupConfig(accum_steps=2)},
                          TO.DEFAULT_GROUP_RULES)
    assert set(accum.accum) == set(accum.params) == set(tstate.optimizers.params)


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """Two steps, a checkpoint, two more; a fresh pipeline loaded from the
    checkpoint takes the same last two steps to the same parameters (the step
    generator's and the sampler's states are in the checkpoint)."""
    _, jstate, _, _ = _jax(0)
    tp, state = _port(jstate, CHUNK)
    for _ in range(2):
        state, _ = tp.train_step(state, *tp.datamanager.next_train())
    path = tp.save_checkpoint(state, tmp_path)
    assert path.name == "step-000000002.pt"
    for _ in range(2):
        state, metrics = tp.train_step(state, *tp.datamanager.next_train())
    fresh, fstate = _port(jstate, CHUNK)
    fresh.load_checkpoint(tmp_path, fstate)
    assert fstate.step == 2 and fstate.optimizers.count == 2
    for _ in range(2):
        fstate, fmetrics = fresh.train_step(fstate, *fresh.datamanager.next_train())
    assert fstate.step == state.step == 4
    assert float(fmetrics["total_loss"]) == float(metrics["total_loss"])
    for (name, p), q in zip(tp.model.named_parameters(), fresh.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)


def test_train_script_and_closed_loop_serve_a_neurad_run(tmp_path):
    argv = ["neurad-tiny", "--device", "cpu", "--output-dir", str(tmp_path), "--experiment-name", "run",
            "--max-iterations", "3", "--set", "trainer.steps_per_log=1", "--dp-set", "num_frames=3",
            "--dp-set", "image_height=36", "--dp-set", "image_width=48"]
    pipeline, state = TTrain.entrypoint(argv)
    assert isinstance(pipeline, TP.ADPipeline) and state.step == 3
    assert pipeline.config.model_overrides["sampling"] == neurad_tiny_overrides()["sampling"]
    assert sorted(p.name for p in (tmp_path / "run" / "checkpoints").glob("*.pt")) == ["step-000000003.pt"]
    # load_run rebuilds the configuration, the settings types included
    loaded, lstate = TTrain.load_run(tmp_path / "run", device="cpu", with_state=True)
    assert loaded.config == pipeline.config and lstate.step == 3
    for (name, p), q in zip(pipeline.model.named_parameters(), loaded.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)
    # the closed-loop server serves the run
    served, port = TCL.state_from_args(["--port", "0", "--load-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert isinstance(served.pipeline, TP.ADPipeline)
    image = served.render_image(torch.eye(4).tolist(), 0.5, "front_camera")
    assert image.shape == (36, 48, 3) and np.isfinite(image).all()
    assert METHODS["neurad"]().pipeline.train_ray_chunk == 8192
    assert METHODS["neurad-parity"]().pipeline.model_overrides["field_static"].parity


@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_loop_counts_rays_and_stops_the_sampler(tmp_path, prefetch):
    """The train script's loop takes NeuRAD batches from `next_train` (prefetch
    0) or the sampler threads, logs the train rays per second at every log
    line and the last step, and stops the threads when it ends."""
    cfg = TP.ADPipelineConfig(datamanager=TDMC(**BATCH, prefetch=prefetch, num_workers=2),
                              model_overrides=neurad_tiny_overrides(), seed=0)
    pipeline = TP.ADPipeline(_outputs(TSynth), cfg, device="cpu")
    trainer = METHODS["neurad-tiny"]().trainer
    trainer.max_num_iterations, trainer.steps_per_log, trainer.steps_per_save = 3, 2, 10**9
    state, history = TTrain.train_loop(pipeline, pipeline.init_state(), trainer, tmp_path)
    assert state.step == 3 and len(history) == 2  # steps 0 and 2
    assert all(h["train_rays_per_sec"] > 0 and math.isfinite(h["total_loss"]) for h in history)
    assert pipeline.datamanager._threads is None and not list(tmp_path.iterdir())
