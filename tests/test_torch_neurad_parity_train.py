"""The `neurad-parity` preset's training against the JAX package's: hash-grid
proposal fields (`proposal_mode="hashgrid"`, and `"hashgrid-shared"`, where
one field serves both proposal rounds), every table in the parity layout
(hashed at every level, unpacked, fp32 reads) and `compute_fp32=True`, at
small widths on the synthetic scene. Parameters are carried across by
`neurad_params_from_flax` and livened as in `test_torch_neurad_train.py`
(tables x 300, the SDF bias at 0.08, the actor 1.5 m ahead); the random
draws are the JAX package's, split as that file splits them. Every JAX
level's table is far under `_FP32_ACCUM_MAX_BYTES`, so JAX sums the table
gradients in fp32 as the port does.

Tolerances, those of `test_torch_neurad_train.py`: losses and metrics to
2e-6 relative; every parameter's gradient within 2e-5 of that parameter's
largest entry plus 1e-8 (both sides form the same fp32 terms and sum them in
other orders; measured 2e-6 to 7e-6 on almost every parameter). The hash
proposal fields have no noise-level MLP. One entry is ill-conditioned
instead: in the shared, chunked case the field's first actor table has an
entry of 3.5e-4 summed from terms of 5.3e-2 in all, and it differs from
JAX's by 2.8e-5 of the table's largest entry. Scaling every parameter of the
port by 1 + 2^-23 * N(0, 1) (about one ulp) moves that gradient by 1.4e-5 to
2.0e-5 of its largest entry. So each gradient is held to the larger of 2e-5
of its largest entry and 4 times that one-ulp movement (`_ulp_noise`),
measured in the test on the same batch. Three steps: the first loss to 2e-6,
the next two to 3e-4; every entry within 2 * lr a step of JAX's and at most
1% of the entries more than 0.1 * lr apart (Adam's first updates are about
lr * sign(g)).

The preset's F = 1 lookups on the card (K1f and K1b at its proposal grids,
against their plain versions) are held in `test_torch_kernels_cuda.py`,
which imports no JAX (the card's machine has none), and at full width by
`chip_smoke.py`.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurad_tpu.configs import method_configs as JMC
from neurad_tpu.data.datamanager import ADDataManagerConfig as JDMC
from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.engine import optimizers as JO
from neurad_tpu.fields import neurad_encoding as JE
from neurad_tpu.models import neurad as JM
from neurad_tpu.ops import hash_encoding as JH
from neurad_tpu.pipelines.ad_pipeline import ADPipeline as JPipe
from neurad_tpu.pipelines.ad_pipeline import ADPipelineConfig as JPipeCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.configs import method_configs as TMC
from neurad_tpu_torch.core.structs import GaussiansStd
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
STEP_LOSS_RTOL = 3e-4
GRAD_TOL, GRAD_ATOL = 2e-5, 1e-8
NOISE_MULT = 4.0  # times the gradient's movement under a one-ulp scaling of the parameters
MODES = ("hashgrid", "hashgrid-shared")


def _overrides(E, M, mode):
    """The preset's overrides (`neurad-parity`) at small widths: every grid
    hashed at every level, unpacked, fp32; F = 1 proposal grids."""
    parity = dict(cell_packed=False, parity=True)
    prop = E.StaticSettings(num_levels=3, base_res=16, max_res=128, log2_hashmap_size=11, hashgrid_dim=1, **parity)
    return dict(
        loss=M.LossSettings(vgg_mult=0.0),
        sampling=M.SamplingSettings(num_proposal_samples=(12, 8), num_nerf_samples=6, sky_distance=1000.0),
        field_static=E.StaticSettings(num_levels=4, base_res=16, max_res=256, log2_hashmap_size=13, hashgrid_dim=4,
                                      **parity),
        field_actor=E.ActorSettings(flip_prob=0.25, num_levels=2, base_res=16, max_res=64, log2_hashmap_size=11,
                                    hashgrid_dim=4, **parity),
        proposal_static=(prop, prop),
        proposal_actor=E.ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=9, hashgrid_dim=1,
                                       **parity),
        proposal_mode=mode, appearance_dim=4, max_actors_per_ray=1, compute_fp32=True,
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


def _jax(mode, chunk):
    """(JAX pipeline, its state with livened parameters, tx, the jitted
    value_and_grad of its loss_fn); its datamanager at the batch after
    init_state's."""
    if (mode, chunk) not in _CACHE:
        cfg = JPipeCfg(datamanager=JDMC(**BATCH), eval_shard=False, train_ray_chunk=chunk,
                       model_overrides=_overrides(JE, JM, mode),
                       optimizer_groups={k: JO.OptimizerGroupConfig(**v) for k, v in GROUPS.items()})
        jp = JPipe(_outputs(JSynth), cfg)
        state, tx = jp.init_state()
        state = state.replace(params=jax.tree.map(jnp.asarray, _scaled(state.params)))
        vg = jax.jit(jax.value_and_grad(jp.loss_fn, has_aux=True))
        _CACHE[(mode, chunk)] = (jp, state, tx, jp.datamanager.rng_state(), vg)
    jp, state, tx, rng_state, vg = _CACHE[(mode, chunk)]
    jp.datamanager.set_rng_state(rng_state)
    return jp, state, tx, vg


def _port(jstate, mode, chunk):
    """The port's pipeline with the JAX state's parameters, and its training state."""
    tp = TP.ADPipeline(_outputs(TSynth), TP.ADPipelineConfig(
        datamanager=TDMC(**BATCH), train_ray_chunk=chunk, model_overrides=_overrides(TE, TM, mode),
        optimizer_groups={k: TO.OptimizerGroupConfig(**v) for k, v in GROUPS.items()}), device="cpu")
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


def _ulp_noise(tp, bundle, batch, draws):
    """Per parameter, the largest movement of the port's gradient when every
    parameter is scaled by 1 + 2^-23 * N(0, 1); the parameters are restored
    and their gradients cleared."""
    params = dict(tp.model.named_parameters())
    grads = {n: p.grad.clone() for n, p in params.items() if p.grad is not None}
    kept = {n: p.detach().clone() for n, p in params.items()}
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in params.values():
            p.mul_(1.0 + 2.0**-23 * torch.randn(p.shape, generator=gen))
            p.grad = None
    loss, _ = tp.loss_fn(bundle, batch, draws)
    loss.backward()
    noise = {n: float((p.grad - grads[n]).abs().max()) if n in grads else 0.0 for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(kept[n])
            p.grad = grads.get(n)
    return noise


def _close(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-6), (what, got, want)


def test_the_small_tables_are_summed_in_fp32_by_jax():
    """Every JAX level's gradient buffer fits `_FP32_ACCUM_MAX_BYTES`, so both
    sides sum the table gradients in fp32; the grids are hashed at every
    level and read fp32 in the port."""
    _, jstate, _, _ = _jax("hashgrid", 0)
    tp, _ = _port(jstate, "hashgrid", 0)
    tables = {n: p for n, p in tp.model.named_parameters() if "hash_table" in n}
    assert len(tables) == 4 + 2 + 2 * (3 + 2)
    assert all(p.numel() * 4 <= JH._FP32_ACCUM_MAX_BYTES for p in tables.values())
    grids = [m for m in tp.model.modules() if isinstance(m, TE.NeuRADHashEncoding)]
    assert len(grids) == 3
    for enc in grids:
        for grid in (enc.static_grid, enc.actor_grid):
            assert grid.force_hash and not grid.cell_packed and grid.gather_dtype is None
            assert grid.dense_res == (None,) * len(grid.scales) and set(grid.pack) == {1}
    assert [g.static_grid.features for g in grids] == [4, 1, 1]


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["whole_batch", "chunked"])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_gradients_match_jax(mode, chunk):
    jp, jstate, _, vg = _jax(mode, chunk)
    tp, _ = _port(jstate, mode, chunk)
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
    noise = _ulp_noise(tp, tb, tbatch, draws)
    labels = TO.label_params(want, TO.DEFAULT_GROUP_RULES)
    moved = set()
    for name, p in tp.model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(want[name].abs().max())
        err = float((got - want[name]).abs().max())
        assert err <= max(GRAD_TOL * scale, NOISE_MULT * noise[name]) + GRAD_ATOL, (name, err, scale, noise[name])
        if scale > 0:
            moved.add(labels[name])
    assert moved == {"fields", "hashgrids", "cnn", "trajectory_opt"}, "every group but the (disabled) camera optimizer"
    n_fields = 1 if mode == "hashgrid-shared" else 2
    for i in range(n_fields):  # every proposal field's static and actor tables and its decoder learn
        for part in ("hashgrid.static_hash_table.0", "hashgrid.actor_hash_table.0", "density_decoder.weight"):
            name = f"proposal_fields.{i}.{part}"
            assert float(want[name].abs().max()) > 0, name
    assert not any(n.startswith(f"proposal_fields.{n_fields}") for n in want)


def test_three_steps_match_jax():
    jp, jstate, tx, vg = _jax("hashgrid", 0)
    tp, tstate = _port(jstate, "hashgrid", 0)
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


@pytest.mark.parametrize("mode", MODES)
def test_optimizer_groups_match_the_jax_labels(mode):
    """Every port parameter lands in the group of its JAX counterpart (each
    flax leaf marked with its index and carried across): the proposal
    tables in `hashgrids`, their density decoders in `fields`."""
    _, jstate, _, _ = _jax(mode, 0)
    tp, tstate = _port(jstate, mode, 0)
    leaves, treedef = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, jstate.params))
    marked = jax.tree_util.tree_unflatten(treedef, [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    jlabels = jax.tree_util.tree_leaves(JO.label_params(jstate.params))
    carried = bridge.neurad_params_from_flax(marked, tp.model.state_dict())
    assert set(carried) == set(dict(tp.model.named_parameters()))
    for name, marker in carried.items():
        assert bool((marker == marker.flatten()[0]).all())
        assert tstate.optimizers.labels[name] == jlabels[int(marker.flatten()[0])], name
    labels = tstate.optimizers.labels
    props = [n for n in labels if n.startswith("proposal_fields.")]
    assert {labels[n] for n in props if "hash_table" in n} == {"hashgrids"}
    assert {labels[n] for n in props if "density_decoder" in n} == {"fields"}
    assert len([n for n in props if "density_decoder" in n]) == (1 if mode == "hashgrid-shared" else 2)


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """Two steps, a checkpoint, two more; a fresh pipeline loaded from the
    checkpoint (which holds the proposal tables and their Adam moments)
    takes the same last two steps to the same parameters."""
    _, jstate, _, _ = _jax("hashgrid", 0)
    tp, state = _port(jstate, "hashgrid", CHUNK)
    for _ in range(2):
        state, _ = tp.train_step(state, *tp.datamanager.next_train())
    path = tp.save_checkpoint(state, tmp_path)
    saved = torch.load(path, map_location="cpu", weights_only=False)
    held = [n for n in saved["model"] if n.startswith("proposal_fields.") and "hash_table" in n]
    assert len(held) == 2 * (3 + 2)
    for _ in range(2):
        state, metrics = tp.train_step(state, *tp.datamanager.next_train())
    fresh, fstate = _port(jstate, "hashgrid", CHUNK)
    fresh.load_checkpoint(tmp_path, fstate)
    assert fstate.step == 2 and fstate.optimizers.count == 2
    for _ in range(2):
        fstate, fmetrics = fresh.train_step(fstate, *fresh.datamanager.next_train())
    assert fstate.step == state.step == 4
    assert float(fmetrics["total_loss"]) == float(metrics["total_loss"])
    for (name, p), q in zip(tp.model.named_parameters(), fresh.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)


def _plain(value):
    if hasattr(value, "_asdict"):
        defaults = type(value)._field_defaults
        return {k: _plain(v) for k, v in value._asdict().items()
                if not (k in ("run_dedup", "segsum_grad_rows") and v == defaults[k])}
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (tuple, list)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def test_the_preset_matches_jax_override_by_override():
    want, got = JMC.get_method_config("neurad-parity"), TMC.METHODS["neurad-parity"]()
    assert (got.method_name, got.description) == (want.method_name, want.description)
    wo, go = want.pipeline.model_overrides, got.pipeline.model_overrides
    assert set(go) == set(wo) == {"sampling", "proposal_mode", "compute_fp32", "field_static", "field_actor",
                                  "proposal_static", "proposal_actor"}
    for key in wo:
        assert _plain(go[key]) == _plain(wo[key]), key
    assert go["proposal_mode"] == "hashgrid" and go["compute_fp32"]
    assert [s.hashgrid_dim for s in go["proposal_static"]] == [1, 1] and go["proposal_actor"].hashgrid_dim == 1
    for key in ("train_ray_chunk", "eval_chunk", "model"):
        assert getattr(got.pipeline, key) == getattr(want.pipeline, key), key
    assert got.pipeline.train_ray_chunk == 8192
    assert _plain(got.pipeline.datamanager) == _plain(want.pipeline.datamanager)
    assert _plain(got.pipeline.optimizer_groups) == _plain(want.pipeline.optimizer_groups)
    assert _plain(got.trainer) == _plain(want.trainer)


def test_proposal_lookups_give_the_actor_tables_a_gradient_but_not_the_trajectories():
    """A proposal field looks actors up with `require_actor_grad=False`: the
    boxes are detached, so a proposal's features move its actor tables and
    never the actor trajectories, which the field's own lookup moves. The
    samples run through the actor's box at t = 0.5 (centre (2.5, 0.1, 1.5))."""
    _, jstate, _, _ = _jax("hashgrid", 0)
    tp, _ = _port(jstate, "hashgrid", 0)
    model = tp.model
    centre = torch.tensor([2.5, 0.1, 1.5])
    along = torch.linspace(-2.0, 2.0, 32)[:, None] * torch.tensor([1.0, 0.0, 0.0])
    offsets = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.2, 0.0], [0.0, 0.0, -0.2], [0.0, -0.1, 0.1]])
    mean = (centre + offsets[:, None, :] + along[None])[:, :, None, :]  # [4 rays, 32 samples, 1, 3]
    samples = GaussiansStd(mean=mean, std=torch.full(mean.shape[:-1] + (1,), 1e-3))
    times = torch.full((4, 1), 0.5)
    traj = {n: p for n, p in model.named_parameters() if n.startswith("actors.")}
    assert traj
    prop = model.proposal_fields[0].hashgrid
    assert not prop.require_actor_grad and model.field.hashgrid.require_actor_grad
    feats, _ = prop(samples, times)
    feats.square().sum().backward()
    assert float(prop.actor_hash_table[0].grad.abs().max()) > 0, "the samples hit the actor"
    assert all(p.grad is None or not bool(p.grad.any()) for p in traj.values())
    feats, _ = model.field.hashgrid(samples, times)
    feats.square().sum().backward()
    assert any(p.grad is not None and bool(p.grad.any()) for p in traj.values())


def test_serving_keeps_no_bf16_copy_of_fp32_tables():
    """The closed-loop state switches bf16 copies on; a parity grid reads its
    fp32 masters, so it holds none and a render makes none."""
    _, jstate, _, _ = _jax("hashgrid", 0)
    tp, _ = _port(jstate, "hashgrid", 0)
    TE.keep_bf16_copies(tp.model)
    grids = [g for m in tp.model.modules() if isinstance(m, TE.NeuRADHashEncoding)
             for g in (m.static_grid, m.actor_grid)]
    assert len(grids) == 6 and all(g.copies is None for g in grids)
    image, _ = tp.render_eval_camera(1)
    assert image.shape == (36, 48, 3) and np.isfinite(image).all()
    assert all(g.copies is None for g in grids)


def _small_parity():
    """The preset with the small tables above (the CPU's size)."""
    cfg = TMC._neurad_parity()
    small = _overrides(TE, TM, "hashgrid")
    cfg.pipeline.model_overrides = dict(
        cfg.pipeline.model_overrides, sampling=small["sampling"],
        **{k: small[k] for k in ("field_static", "field_actor", "proposal_static", "proposal_actor")})
    return cfg


def test_train_script_and_closed_loop_serve_a_parity_run(tmp_path, monkeypatch):
    """`scripts.train neurad-parity` (its tables made small) writes a run that
    `ClosedLoopState.from_run_dir` serves, reading the proposal tables back."""
    monkeypatch.setitem(TMC.METHODS, "neurad-parity", _small_parity)
    argv = ["neurad-parity", "--device", "cpu", "--output-dir", str(tmp_path), "--experiment-name", "run",
            "--max-iterations", "2", "--set", "trainer.steps_per_log=1", "--set", "pipeline.train_ray_chunk=48",
            "--set", "pipeline.datamanager.num_cam_patches=2", "--set", "pipeline.datamanager.patch_size=4",
            "--set", "pipeline.datamanager.num_lidar_rays=64", "--dp-set", "num_frames=3",
            "--dp-set", "image_height=36", "--dp-set", "image_width=48"]
    pipeline, state = TTrain.entrypoint(argv)
    assert state.step == 2 and pipeline.config.model_overrides["proposal_mode"] == "hashgrid"
    assert pipeline.config.train_ray_chunk == 48 and len(pipeline._chunks(96)) == 2
    served = TCL.ClosedLoopState.from_run_dir(tmp_path / "run", device="cpu")
    for (name, p), q in zip(pipeline.model.named_parameters(), served.pipeline.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)
    image = served.render_image(torch.eye(4).tolist(), 0.5, "front_camera")
    assert image.shape == (36, 48, 3) and np.isfinite(image).all()


def test_closed_loop_builds_a_seeded_parity_state(monkeypatch):
    """`scripts.closed_loop --method neurad-parity` serves the preset drawn
    from a seed (its tables made small here), with no bf16 copies."""
    monkeypatch.setitem(TMC.METHODS, "neurad-parity", _small_parity)
    served, port = TCL.state_from_args(["--method", "neurad-parity", "--device", "cpu", "--port", "0", "--seed", "3"])
    cfg = served.pipeline.config
    assert port == 0 and cfg.seed == 3 and cfg.train_ray_chunk == 8192
    assert cfg.model_overrides["proposal_mode"] == "hashgrid" and cfg.model_overrides["compute_fp32"]
    model = served.pipeline.model
    assert len(model.proposal_fields) == 2 and all(isinstance(f, TM.NeuRADProposalField) for f in model.proposal_fields)
    assert all(g.copies is None for m in model.modules() if isinstance(m, TE.NeuRADHashEncoding)
               for g in (m.static_grid, m.actor_grid))
