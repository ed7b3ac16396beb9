"""Data-parallel training over `torch.distributed` (the port's
`parallel/sharding.py` and the pipelines' `make_sharded_train_step`) against
the JAX package's mesh-sharded steps, in a world of two gloo ranks on the CPU.

The ranks are two processes of this file (`python tests/test_torch_data_parallel.py
<rank> <dir>`), started once for the whole file; they meet through a file in
the test's directory, import no JAX, take their inputs (parameters carried from
the JAX models, the JAX package's draws) from `inputs.pt` and write what they
saw to `rank<r>.pt`. The JAX references run in this process on a 2-device mesh
(`make_mesh(jax.devices()[:2])`), while the ranks run.

What is held, and how closely:

- SplatAD (Default strategy, fp32 decoders on both sides) and splatfacto:
  one sharded camera step and one sharded lidar step under plain SGD (lr
  1e-2), as `tests/parallel/test_splat_data_parallel.py` does: under Adam a
  noise-level gradient whose sign flips with the order of a sum moves its
  entry by a whole lr. Parameters after the step are held per tensor to lr
  times 1.2e-3 of the tensor's largest gradient entry, plus 1e-6: the
  gradients of the two packages agree to 2e-4 of their largest entry plus
  1e-3 relative (tests/test_torch_splatad_train.py). The Default strategy's
  absgrad sums to the same bound, its visibility counts exactly. The port's
  one-process batched steps (`_make_camera_step_batched`,
  `_make_lidar_step_batched`, splatfacto's `_make_step_batched`) are held to
  the same bounds against JAX's batched steps.
- NeuRAD: the 2-rank step (each rank its own batch, seeded `seed + 7919 *
  rank`; the global batch's draws, JAX's, handed to both) against JAX's
  one-process step of the global batch `[cam_0 | cam_1 | lidar_0 | lidar_1]`
  with `train_ray_chunk=0` (the layout of tests/parallel/test_multihost_2proc.py):
  the loss to 1e-3 relative (that test's bound; measured ~1e-6), the averaged
  gradients per tensor to 2e-5 of the tensor's largest entry plus 1e-8 (5e-2
  in the MLP proposal fields' noise-level gradients), the bounds of
  tests/test_torch_neurad_train.py.
- Parameters are bit-equal on both ranks after every step, an MCMC refine
  and the sampler included; the sharded eval render and `eval_metrics` equal
  the one-process ones bit for bit; the train script in the 2-rank world
  writes one checkpoint (rank 0) and both ranks resume from it.
"""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig as TDMC
from neurad_tpu_torch.model_components.strategy import DefaultStrategyConfig as TDefault
from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig as TMCMC
from neurad_tpu_torch.models.splatad import SplatADConfig as TSplatADConfig
from neurad_tpu_torch.parallel import sharding
from neurad_tpu_torch.pipelines import ad_pipeline as TAD
from neurad_tpu_torch.pipelines import splatad_pipeline as TSP
from neurad_tpu_torch.pipelines import splatfacto_pipeline as TSF

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
LR = 1e-2  # plain SGD in the splat comparisons
PARAM_OF_MAX_GRAD = 1.2e-3  # an SGD step's parameter bound, in lr times the tensor's largest gradient entry
SPLAT_SCENE = dict(num_frames=5, image_height=32, image_width=48, lidar_channels=8, lidar_azimuths=90)
SPLAT_MODEL = dict(num_downscales=0, feature_dim=8, appearance_dim=4, max_per_tile=64, lidar_max_per_tile=32)
SPLAT_CAP = 512
FACTO_SCENE = dict(num_frames=4, image_height=32, image_width=48)
FACTO = dict(capacity=512, num_init=256)
NEURAD_SCENE = dict(num_frames=5, image_height=36, image_width=48, lidar_channels=8, lidar_azimuths=60)
NEURAD_BATCH = dict(num_cam_patches=2, patch_size=4, num_lidar_rays=64)  # 32 camera + 64 lidar rays a rank
NEURAD_GROUPS = dict(fields=dict(lr=5e-3, warmup_steps=0), hashgrids=dict(lr=5e-3, warmup_steps=0),
                     cnn=dict(lr=5e-3, warmup_steps=0), trajectory_opt=dict(lr=1e-4, warmup_steps=0),
                     camera_opt=dict(lr=1e-4, warmup_steps=0))
NEURAD_SEED = 0
LOSS_RTOL = 1e-3
GRAD_TOL, GRAD_ATOL, NOISE_TOL = 2e-5, 1e-8, 5e-2


# ----------------------------------------------------------------------------
# configurations, written once for both packages (a package's modules passed in)
# ----------------------------------------------------------------------------


def _splatad_config(P, DMC, Cfg, MCMC, Default, strategy):
    return P.SplatADPipelineConfig(
        datamanager=DMC(max_lidar_points=512), model=Cfg(**SPLAT_MODEL), strategy=strategy,
        # no refine in the step comparisons; the MCMC world refines at step 2
        mcmc=MCMC(cap_max=SPLAT_CAP, refine_start_iter=1 if strategy == "mcmc" else 10**9, refine_every=2),
        default_strategy=Default(refine_start_iter=10**9, reset_every=10**9), cap_max=SPLAT_CAP)


def _neurad_overrides(E, M):
    prop = E.StaticSettings(num_levels=2, base_res=16, max_res=128, log2_hashmap_size=11, hashgrid_dim=1)
    return dict(
        loss=M.LossSettings(vgg_mult=0.0),
        sampling=M.SamplingSettings(num_proposal_samples=(12, 8), num_nerf_samples=6, sky_distance=1000.0),
        field_static=E.StaticSettings(num_levels=4, base_res=16, max_res=256, log2_hashmap_size=13, hashgrid_dim=4),
        field_actor=E.ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=11, hashgrid_dim=4),
        proposal_static=(prop, prop),
        proposal_actor=E.ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=9, hashgrid_dim=1),
        appearance_dim=4, max_actors_per_ray=1, compute_fp32=True,
        # every actor hit looked up: the compacted lookup's capacity is a render's (a rank's rows here, the
        # global batch in JAX's step), so where it overflows the two keep different samples
        actor_compaction=1,
    )


def _neurad_outputs(synth):
    """The synthetic scene with its actor 1.5 m ahead of the ego vehicle (tests/test_torch_neurad_train.py)."""
    out = synth(**NEURAD_SCENE).setup().get_dataparser_outputs()
    traj = out.trajectories[0]
    stamps = np.asarray(traj["timestamps"])
    traj["poses"] = np.array(traj["poses"])
    traj["poses"][:, :3, 3] = np.stack([2.0 * stamps + 1.5, np.full(len(stamps), 0.1), np.full(len(stamps), 1.5)], -1)
    traj["dims"] = np.array([1.2, 1.2, 1.2], np.float32)
    return out


def _port_neurad(mesh=None, vgg_and_batch_norm=False):
    from neurad_tpu_torch.data.datamanager import ADDataManagerConfig
    from neurad_tpu_torch.engine.optimizers import OptimizerGroupConfig
    from neurad_tpu_torch.fields import neurad_encoding as TE
    from neurad_tpu_torch.models import neurad as TM

    overrides = _neurad_overrides(TE, TM)
    if vgg_and_batch_norm:  # the VGG term and a batch-norm decoder: a mean over patches, the batch's statistics
        overrides.update(loss=TM.LossSettings(), rgb_decoder_norm="batch")
    cfg = TAD.ADPipelineConfig(
        datamanager=ADDataManagerConfig(**NEURAD_BATCH), train_ray_chunk=0, eval_chunk=256,
        model_overrides=overrides, seed=NEURAD_SEED,
        optimizer_groups={k: OptimizerGroupConfig(**v) for k, v in NEURAD_GROUPS.items()})
    return TAD.ADPipeline(_neurad_outputs(TSynth), cfg, device="cpu", mesh=mesh)


def _port_splatad(strategy, mesh=None):
    pipe = TSP.SplatADPipeline(TSynth(**SPLAT_SCENE).setup().get_dataparser_outputs(),
                               _splatad_config(TSP, TDMC, TSplatADConfig, TMCMC, TDefault, strategy),
                               device="cpu", mesh=mesh)
    for module in pipe.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    return pipe


def _port_splatfacto(mesh=None):
    return TSF.SplatfactoPipeline(TSynth(**FACTO_SCENE).setup().get_dataparser_outputs(),
                                  TSF.SplatfactoPipelineConfig(**FACTO), device="cpu", mesh=mesh)


class SGD:
    """Plain SGD in the place of `Optimizers` (the same interface for the
    data-parallel steps: `params` by group, `zero_grad`, `step`)."""

    def __init__(self, module, lr=LR):
        self.params = {"all": list(module.parameters())}
        self.optimizers, self.accum, self.lr = {}, {}, lr

    def zero_grad(self):
        for p in self.params["all"]:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params["all"]:
            if p.grad is not None:
                p -= self.lr * p.grad


def _samples(dm, want_camera, rank=None):
    """The next `WORLD` samples of the wanted modality (the loop of
    tests/parallel/test_splat_data_parallel.py)."""
    for _ in range(64):
        samples = dm.next_train_batch(WORLD) if rank is None else dm.next_train_batch(WORLD, rank=rank)
        built = samples[0 if rank is None else rank]
        if (type(built).__name__ == "CameraSample") == want_camera:  # either package's sample
            return samples
    raise AssertionError("modality never sampled")


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


# ----------------------------------------------------------------------------
# the ranks (no JAX here)
# ----------------------------------------------------------------------------


def _rank_main(rank: int, workdir: Path) -> None:
    from neurad_tpu_torch.scripts import train as TTrain

    mesh = sharding.make_mesh(device="cpu", rank=rank, world_size=WORLD,
                              init_method=f"file://{workdir / 'rendezvous'}")
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {}

    # SplatAD, Default strategy: a camera step (absgrad sums) and a lidar step from the same parameters, SGD
    pipe = _port_splatad("default", mesh)
    for kind in ("camera", "lidar"):
        pipe.model.load_state_dict(inputs["splatad"])
        pipe._grad2d_sum = pipe._count = None
        state = pipe.init_state()
        state.optimizers = SGD(pipe.model)
        samples = _samples(pipe.datamanager, kind == "camera", rank)
        state, metrics = pipe.make_sharded_train_step()(state, samples)
        out[f"splatad_{kind}"] = dict(params=_params(pipe.model), loss=float(metrics["total_loss"]),
                                      grads={n: p.grad.clone() for n, p in pipe.model.named_parameters()})
        if kind == "camera":
            out["splatad_camera"].update(g2d=pipe._grad2d_sum.clone(), count=pipe._count.clone())

    # SplatAD, MCMC: three Adam steps with a refine at step 2; the ranks must hold the same bits
    pipe = _port_splatad("mcmc", mesh)
    pipe.model.load_state_dict(inputs["splatad"])
    state = pipe.init_state()
    run = pipe.make_sharded_train_step()
    kinds = []
    for want_camera in (True, False, True):
        samples = _samples(pipe.datamanager, want_camera, rank)
        kinds.append(type(samples[rank]).__name__)
        state, _ = run(state, samples)
    out["mcmc"] = dict(params=_params(pipe.model), kinds=kinds, step=state.step,
                       moments=[t.clone() for t in sharding.optimizer_tensors(state.optimizers)])

    # splatfacto: one camera a rank, SGD
    pipe = _port_splatfacto(mesh)
    pipe.model.load_state_dict(inputs["splatfacto"])
    state = pipe.init_state()
    state.optimizers = SGD(pipe.model)
    state, metrics = pipe.make_sharded_train_step()(state)
    out["splatfacto"] = dict(params=_params(pipe.model), loss=float(metrics["total_loss"]),
                             g2d=pipe._grad2d_sum.clone(), count=pipe._count.clone())

    # NeuRAD: the global batch's step, JAX's draws
    pipe = _port_neurad(mesh)
    pipe.model.load_state_dict(inputs["neurad"])
    state = pipe.init_state()
    bundle, batch = pipe.datamanager.next_train()
    state, metrics = pipe.make_sharded_train_step()(state, bundle, batch, draws=inputs["neurad_draws"])
    out["neurad"] = dict(loss=float(metrics["total_loss"]), metrics={k: float(v) for k, v in metrics.items()},
                         grads={n: p.grad.clone() for n, p in pipe.model.named_parameters()},
                         params=_params(pipe.model))
    # NeuRAD with the VGG term and a batch-norm decoder, under SGD: held in this file's process against the
    # one-process step of the global batch, which rank 0 saves
    pipe = _port_neurad(mesh, vgg_and_batch_norm=True)
    pipe.model.load_state_dict(inputs["neurad"], strict=False)
    state = pipe.init_state()
    state.optimizers = SGD(pipe.model)
    bundle, batch = pipe.datamanager.next_train()
    global_batch = sharding.assemble_global_train_batch(mesh, bundle, batch, pipe.num_cam_rays)
    state, metrics = pipe.make_sharded_train_step()(state, bundle, batch, draws=inputs["neurad_draws"])
    out["neurad_vgg_batch_norm"] = dict(
        metrics={k: float(v) for k, v in metrics.items()}, global_batch=global_batch if rank == 0 else None,
        grads={n: p.grad.clone() for n, p in pipe.model.named_parameters()},
        buffers={n: b.clone() for n, b in pipe.model.named_buffers() if "running" in n})

    # sharded eval against the one-process render of the same parameters
    sharded = pipe.render_eval_camera(0)[0], pipe.render_eval_lidar(pipe.outputs.eval_lidar_indices[0]), \
        pipe.eval_metrics()
    pipe.config.eval_shard = False
    alone = pipe.render_eval_camera(0)[0], pipe.render_eval_lidar(pipe.outputs.eval_lidar_indices[0]), \
        pipe.eval_metrics()
    out["eval"] = dict(sharded=sharded, alone=alone)

    # the train script in this world: one checkpoint, then a resume from it
    run_dir = workdir / "runs" / "r"
    argv = ["splatad-tiny", "--device", "cpu", "--output-dir", str(workdir / "runs"), "--experiment-name", "r",
            "--set", "pipeline.cap_max=512", "--set", "pipeline.mcmc.cap_max=512", "--dp-set", "image_height=32",
            "--dp-set", "image_width=48"]
    _, state = TTrain.entrypoint(argv + ["--max-iterations", "3"], mesh=mesh)
    first = dict(step=state.step, files=sorted(p.name for p in (run_dir / "checkpoints").iterdir()))
    sharding.barrier(mesh)
    pipe, state = TTrain.entrypoint(["splatad-tiny", "--device", "cpu", "--load-dir", str(run_dir),
                                     "--max-iterations", "4"], mesh=mesh)
    out["script"] = dict(first=first, step=state.step, params=_params(pipe.model),
                         files=sorted(p.name for p in (run_dir / "checkpoints").iterdir()))
    torch.save(out, workdir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


# ----------------------------------------------------------------------------
# this process: the inputs, the ranks, the JAX references
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's pipelines (fp32 decoders), their initial states and
    the NeuRAD step's key and draws."""
    import jax
    import jax.numpy as jnp

    from neurad_tpu.data.datamanager import ADDataManagerConfig as JADMC
    from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
    from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManagerConfig as JDMC
    from neurad_tpu.engine import optimizers as JO
    from neurad_tpu.fields import neurad_encoding as JE
    from neurad_tpu.model_components.strategy import DefaultStrategyConfig as JDefault
    from neurad_tpu.model_components.strategy import MCMCStrategyConfig as JMCMC
    from neurad_tpu.models import neurad as JM
    from neurad_tpu.models import splatad as JS
    from neurad_tpu.pipelines import ad_pipeline as JAD
    from neurad_tpu.pipelines import splatad_pipeline as JSP
    from neurad_tpu.pipelines import splatfacto_pipeline as JSF
    from neurad_tpu_torch import params_from_jax as bridge

    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "RGBDecoderCNN", functools.partial(JS.RGBDecoderCNN, compute_dtype=jnp.float32))
    mp.setattr(JS, "MLP", functools.partial(JS.MLP, compute_dtype=jnp.float32))
    side = {"jax": jax, "bridge": bridge}
    jsp = JSP.SplatADPipeline(JSynth(**SPLAT_SCENE).setup().get_dataparser_outputs(),
                              _splatad_config(JSP, JDMC, JS.SplatADConfig, JMCMC, JDefault, "default"))
    side["splatad"] = (jsp, jsp.init_state(jax.random.PRNGKey(0)))
    jsf = JSF.SplatfactoPipeline(JSynth(**FACTO_SCENE).setup().get_dataparser_outputs(),
                                 JSF.SplatfactoPipelineConfig(**FACTO))
    side["splatfacto"] = (jsf, jsf.init_state(jax.random.PRNGKey(3))[0])

    jad = JAD.ADPipeline(_neurad_outputs(JSynth), JAD.ADPipelineConfig(
        datamanager=JADMC(**NEURAD_BATCH), eval_shard=False, train_ray_chunk=0,
        model_overrides=_neurad_overrides(JE, JM), seed=NEURAD_SEED,
        optimizer_groups={k: JO.OptimizerGroupConfig(**v) for k, v in NEURAD_GROUPS.items()}))
    jstate, _ = jad.init_state()

    def liven(tree):  # tables by 300, the SDF bias at 0.08 (tests/test_torch_neurad_train.py)
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

    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, liven(jstate.params)))
    _, step_rng = jax.random.split(jstate.rng)
    n_global = WORLD * (jad.num_cam_rays + NEURAD_BATCH["num_lidar_rays"])
    samp, flip = jax.random.split(step_rng)
    level_keys = jax.random.split(samp, 3)  # two proposal rounds and the field's (tests/test_torch_neurad_train.py)
    draws = [TAD.ChunkDraws(tuple(torch.from_numpy(np.array(jax.random.uniform(k, (n_global, 1))))
                                  for k in level_keys),
                            torch.from_numpy(np.array(jax.random.uniform(flip, (n_global,)))))]
    side["neurad"] = (jad, jstate, step_rng, draws)
    yield side
    mp.undo()


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Start the two ranks on the carried parameters; yields a function that
    waits for them and returns what each saw."""
    jax, bridge = jax_side["jax"], jax_side["bridge"]
    workdir = tmp_path_factory.mktemp("dp")
    like = _port_neurad().model.state_dict()
    torch.save({
        "splatad": bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jax_side["splatad"][1].params)),
        "splatfacto": bridge.splatfacto_params_from_flax(jax.tree.map(np.asarray, jax_side["splatfacto"][1].params)),
        "neurad": bridge.neurad_params_from_flax(jax.tree.map(np.asarray, jax_side["neurad"][1].params), like),
        "neurad_draws": jax_side["neurad"][3],
    }, workdir / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}", "OMP_NUM_THREADS": "1"}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(workdir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    result = {}

    def wait():
        if not result:
            logs = [p.communicate(timeout=900)[0] for p in procs]
            for p, log in zip(procs, logs):
                assert p.returncode == 0, log[-4000:]
            result.update({r: torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)})
            result["workdir"] = workdir
        return result

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _assert_same_bits(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k} differs between the ranks"


def _assert_params_near(got, want, grads, what):
    """SGD parameters per tensor: lr * 1.2e-3 of the tensor's largest gradient entry, plus 1e-6 and
    3e-7 of the entry (a few fp32 ulps: an update rounds where the entry is large)."""
    assert got.keys() == want.keys()
    for k in want:
        g = grads.get(k.removeprefix("model."), grads.get(k))
        scale = float(g.abs().max()) if g is not None else 0.0
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=3e-7,
                                   atol=LR * PARAM_OF_MAX_GRAD * scale + 1e-6, err_msg=f"{what}: {k}")


def _sgd_start(jpipe, jstate):
    """A copy of a JAX state with SGD's (empty) state: the jitted steps donate their state."""
    import jax
    import jax.numpy as jnp

    jstate = jax.tree.map(jnp.array, jstate)
    return jstate.replace(opt_state=jpipe.tx.init(jstate.params))


def _jax_splat_batch(samples, camera):
    import jax.numpy as jnp

    b = lambda f, dt=None: jnp.asarray(np.stack([np.asarray(f(s)) for s in samples]), dtype=dt)
    if camera:
        return (b(lambda s: s.c2w), b(lambda s: s.K), b(lambda s: s.image), b(lambda s: s.time, jnp.float32),
                b(lambda s: s.sensor_idx, jnp.int32), b(lambda s: s.cam_idx, jnp.int32),
                b(lambda s: s.linear_velocity, jnp.float32), b(lambda s: s.rolling_shutter_time, jnp.float32),
                b(lambda s: s.time_to_center_pixel, jnp.float32))
    return (b(lambda s: s.l2w), b(lambda s: s.raster_pts), b(lambda s: s.did_return), b(lambda s: s.valid),
            b(lambda s: s.time, jnp.float32), b(lambda s: s.sensor_idx, jnp.int32),
            b(lambda s: s.linear_velocity, jnp.float32))


@pytest.mark.parametrize("kind", ["camera", "lidar"])
def test_splatad_sharded_and_batched_steps_match_jax(jax_side, ranks, kind):
    """The 2-rank step and the one-process batched step against JAX's
    `make_sharded_train_step` on a 2-device mesh and its batched step, under
    SGD; the camera step's absgrad sums and counts too."""
    import optax

    jax, bridge = jax_side["jax"], jax_side["bridge"]
    from neurad_tpu.parallel.sharding import make_mesh

    jsp, jstate0 = jax_side["splatad"]
    jsp.tx = optax.sgd(LR)
    jsp._grad2d_sum = jsp._count = None
    jsp.datamanager._rng, jsp.datamanager._raster_cache = np.random.default_rng(0), {}
    for _ in range(1 if kind == "lidar" else 0):  # the ranks drew the camera batch first
        _samples(jsp.datamanager, True)
    jsamples = _samples(jsp.datamanager, kind == "camera")
    sharded = jsp.make_sharded_train_step(make_mesh(jax.devices()[:WORLD]))
    jstate, _ = sharded(_sgd_start(jsp, jstate0), jsamples)
    want = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params))

    got = ranks()
    _assert_same_bits(got[0][f"splatad_{kind}"]["params"], got[1][f"splatad_{kind}"]["params"], kind)
    grads = got[0][f"splatad_{kind}"]["grads"]
    _assert_params_near(got[0][f"splatad_{kind}"]["params"], want, grads, f"sharded {kind}")

    # the one-process batched step on the same samples
    tp = _port_splatad("default")
    tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate0.params)))
    tstate = tp.init_state()
    tstate.optimizers = SGD(tp.model)
    for _ in range(1 if kind == "lidar" else 0):
        _samples(tp.datamanager, True)
    tsamples = _samples(tp.datamanager, kind == "camera")
    assert [getattr(s, "cam_idx", getattr(s, "scan_idx", None)) for s in tsamples] == \
        [getattr(s, "cam_idx", getattr(s, "scan_idx", None)) for s in jsamples]
    if kind == "camera":
        tstate, tmetrics, (g2d, count) = tp._make_camera_step_batched()(tstate, tsamples)
        jstep = jsp._make_camera_step_batched()
        jb, jm, (jg2d, jcount) = jstep(_sgd_start(jsp, jstate0), *_jax_splat_batch(jsamples, True))
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
        np.testing.assert_allclose(g2d.numpy(), np.asarray(jg2d), rtol=1e-3, atol=2e-4 * float(np.max(jg2d)))
        # the ranks' absgrad sums: the same statistics summed over the world
        np.testing.assert_array_equal(got[0]["splatad_camera"]["count"].numpy(), np.asarray(jcount))
        np.testing.assert_allclose(got[0]["splatad_camera"]["g2d"].numpy(), np.asarray(jg2d), rtol=1e-3,
                                   atol=2e-4 * float(np.max(jg2d)))
        assert torch.equal(got[0]["splatad_camera"]["g2d"], got[1]["splatad_camera"]["g2d"])
    else:
        tstate, tmetrics = tp._make_lidar_step_batched()(tstate, tsamples)
        jb, jm = jsp._make_lidar_step_batched()(_sgd_start(jsp, jstate0), *_jax_splat_batch(jsamples, False))
    np.testing.assert_allclose(float(tmetrics["total_loss"]), float(jm["total_loss"]), rtol=2e-5)
    np.testing.assert_allclose(got[0][f"splatad_{kind}"]["loss"], float(jm["total_loss"]), rtol=2e-5)
    _assert_params_near(_params(tp.model), bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jb.params)),
                        grads, f"batched {kind}")


def test_splatfacto_sharded_and_batched_steps_match_jax(jax_side, ranks):
    import optax

    jax, bridge = jax_side["jax"], jax_side["bridge"]
    import jax.numpy as jnp
    from neurad_tpu.parallel.sharding import make_mesh

    jsf, jstate0 = jax_side["splatfacto"]
    jsf.tx = optax.sgd(LR)
    jsf._order = np.random.default_rng(jsf.config.seed)
    jsf._grad2d_sum, jsf._count = jnp.zeros_like(jsf._grad2d_sum), jnp.zeros_like(jsf._count)
    jstate, _ = jsf.make_sharded_train_step(make_mesh(jax.devices()[:WORLD]))(_sgd_start(jsf, jstate0))
    want = bridge.splatfacto_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = ranks()
    _assert_same_bits(got[0]["splatfacto"]["params"], got[1]["splatfacto"]["params"], "splatfacto")

    tp = _port_splatfacto()
    tp.model.load_state_dict(bridge.splatfacto_params_from_flax(jax.tree.map(np.asarray, jstate0.params)))
    tstate = tp.init_state()
    tstate.optimizers = SGD(tp.model)
    idxs = tp._draw_cameras(WORLD)
    c2w, K, img = zip(*(tp._camera(i) for i in idxs))
    tstate, tmetrics, (g2d, count) = tp._make_step_batched()(tstate, idxs)
    h, w = img[0].shape[:2]
    jsf._grad2d_sum, jsf._count = jnp.zeros_like(jsf._grad2d_sum), jnp.zeros_like(jsf._count)
    jb, jm, (jg2d, jcount) = jsf._make_step_batched(h, w)(_sgd_start(jsf, jstate0), jnp.asarray(np.stack(c2w)), jnp.asarray(np.stack(K)),
                                                        jnp.asarray(np.stack([i.numpy() for i in img])))
    grads = {k: (v - want[k]) / LR for k, v in bridge.splatfacto_params_from_flax(
        jax.tree.map(np.asarray, jstate0.params)).items()}  # SGD: the step is lr times the gradient
    _assert_params_near(got[0]["splatfacto"]["params"], want, grads, "sharded")
    _assert_params_near(_params(tp.model), bridge.splatfacto_params_from_flax(jax.tree.map(np.asarray, jb.params)),
                        grads, "batched")
    for g, c in ((got[0]["splatfacto"]["g2d"], got[0]["splatfacto"]["count"]), (g2d, count)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jcount))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg2d), rtol=1e-3, atol=2e-4 * float(np.max(jg2d)))
    np.testing.assert_allclose(got[0]["splatfacto"]["loss"], float(jm["total_loss"]), rtol=2e-5)


def test_neurad_two_rank_step_is_the_global_batch_step(jax_side, ranks):
    """Each rank samples its own rays; the averaged gradients are the JAX
    package's one-process gradients of the global batch."""
    jax, bridge = jax_side["jax"], jax_side["bridge"]
    jad, jstate, step_rng, _ = jax_side["neurad"]
    C = jad.num_cam_rays
    local = []
    for r in range(WORLD):
        jad.datamanager.set_rng_state(np.random.default_rng(sharding.host_local_seed(NEURAD_SEED, r)).bit_generator.state)
        jad.datamanager.next_train()  # init_state's draw
        local.append(jad.datamanager.next_train())
    (b0, g0), (b1, g1) = local
    cat = lambda *xs: np.concatenate([np.asarray(x) for x in xs])
    bundle = jax.tree.map(lambda a, b: cat(a[:C], b[:C], a[C:], b[C:]), b0, b1)
    batch = jax.tree.map(lambda a, b: cat(a, b), g0, g1)
    jad._train_num_cam_rays = WORLD * C
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jad.loss_fn, has_aux=True))(
        jstate.params, bundle, batch, step_rng)

    got = ranks()
    r0, r1 = got[0]["neurad"], got[1]["neurad"]
    _assert_same_bits(r0["params"], r1["params"], "neurad")
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], float(jloss), rtol=LOSS_RTOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(r0["metrics"][k], float(v), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want = bridge.neurad_params_from_flax(jax.tree.map(np.asarray, jgrads), r0["params"])
    for name, g in r0["grads"].items():
        scale = float(want[name].abs().max())
        tol = (NOISE_TOL if name.startswith("proposal_fields") and ".mlp." in name else GRAD_TOL) * scale + GRAD_ATOL
        assert float((g - want[name]).abs().max()) <= tol, (name, float((g - want[name]).abs().max()), scale)
        assert torch.equal(g, r1["grads"][name]), f"{name}: the averaged gradient differs between the ranks"


def test_neurad_vgg_and_batch_norm_over_the_ranks_are_the_global_batch(ranks):
    """Each rank decodes and scores its own rows: the VGG term (a mean over
    patches), the masked means whose counts differ by rank, the depth
    loss's quantile and a batch-norm decoder's statistics are reduced over
    the ranks. The averaged gradients, the metrics and the running averages
    are the one-process step's of the global batch, to fp32 summation order:
    the loss and metrics to 1e-5 relative, the gradients per tensor to 2e-5
    of the tensor's largest entry plus 1e-8 (5e-2 in the MLP proposal
    fields' noise-level gradients; the decoder's conv biases in front of a
    batch norm, whose gradients cancel, below 1e-5 of the decoder's largest
    entry on both sides), the running averages to 1e-6."""
    got = ranks()
    r0, r1 = got[0]["neurad_vgg_batch_norm"], got[1]["neurad_vgg_batch_norm"]
    assert r0["metrics"] == r1["metrics"]
    inputs = torch.load(got["workdir"] / "inputs.pt", weights_only=False)
    pipe = _port_neurad(vgg_and_batch_norm=True)
    assert pipe.vgg is not None and any("running_mean" in n for n, _ in pipe.model.named_buffers())
    pipe.model.load_state_dict(inputs["neurad"], strict=False)
    bundle, batch = r0["global_batch"]
    n_cam = WORLD * pipe.num_cam_rays
    total, metrics = pipe._loss_of_outputs(pipe._ray_outputs(bundle, inputs["neurad_draws"], n_cam), batch, n_cam)
    total.backward()
    np.testing.assert_allclose(r0["metrics"]["total_loss"], float(total.detach()), rtol=1e-5)
    assert r0["metrics"]["vgg_loss"] > 0
    for k, v in metrics.items():
        np.testing.assert_allclose(r0["metrics"][k], float(v), rtol=1e-5, atol=1e-8, err_msg=k)
    decoder_scale = max(float(p.grad.abs().max()) for n, p in pipe.model.named_parameters()
                        if n.startswith("rgb_decoder."))
    for name, p in pipe.model.named_parameters():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        if re.fullmatch(r"rgb_decoder\.blocks\.\d\.conv[12]\.bias", name):
            # a per-channel bias in front of a batch norm cancels: its gradient is rounding noise on both sides
            assert max(float(want.abs().max()), float(r0["grads"][name].abs().max())) <= 1e-5 * decoder_scale, name
            continue
        scale = float(want.abs().max())
        tol = (NOISE_TOL if name.startswith("proposal_fields") and ".mlp." in name else GRAD_TOL) * scale + GRAD_ATOL
        assert float((r0["grads"][name] - want).abs().max()) <= tol, (name, scale)
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    buffers = dict(pipe.model.named_buffers())
    assert r0["buffers"]
    for name, b in r0["buffers"].items():
        torch.testing.assert_close(b, buffers[name], rtol=1e-6, atol=1e-6)
        assert torch.equal(b, r1["buffers"][name]), name


def test_ranks_stay_bit_equal_through_an_mcmc_refine(ranks):
    got = ranks()
    a, b = got[0]["mcmc"], got[1]["mcmc"]
    assert a["kinds"] == b["kinds"] and a["step"] == b["step"] == 3
    assert set(a["kinds"]) == {"CameraSample", "LidarSample"}
    assert TMCMC(cap_max=SPLAT_CAP, refine_start_iter=1, refine_every=2).refine_every == 2  # refined at step 2
    _assert_same_bits(a["params"], b["params"], "after the refine")
    assert len(a["moments"]) == len(b["moments"]) > 0
    assert all(torch.equal(x, y) for x, y in zip(a["moments"], b["moments"]))


def test_sharded_eval_is_the_one_process_render(ranks):
    got = ranks()
    for r in range(WORLD):
        (cam_s, lidar_s, metrics_s), (cam_a, lidar_a, metrics_a) = got[r]["eval"]["sharded"], got[r]["eval"]["alone"]
        np.testing.assert_array_equal(cam_s, cam_a)
        assert lidar_s.keys() == lidar_a.keys()
        for k in lidar_s:
            np.testing.assert_array_equal(lidar_s[k], lidar_a[k], err_msg=k)
        assert metrics_s == metrics_a and {"psnr", "depth_median_l2"} <= set(metrics_s)
    np.testing.assert_array_equal(got[0]["eval"]["sharded"][0], got[1]["eval"]["sharded"][0])


def test_train_script_in_a_two_rank_world_checkpoints_once_and_resumes(ranks):
    got = ranks()
    a, b = got[0]["script"], got[1]["script"]
    assert a["first"] == b["first"] == dict(step=3, files=["step-000000003.pt"])
    assert a["step"] == b["step"] == 4
    assert a["files"] == b["files"] == ["step-000000003.pt", "step-000000004.pt"]
    _assert_same_bits(a["params"], b["params"], "after the resume")
    run_dir = got["workdir"] / "runs" / "r"
    assert sorted(p.name for p in run_dir.iterdir()) == ["checkpoints", "config.json", "tb"] or \
        sorted(p.name for p in run_dir.iterdir()) == ["checkpoints", "config.json"]


def test_train_script_spawns_one_rank_per_gpu(tmp_path, monkeypatch):
    """Started plainly where more than one GPU is visible, the train script
    spawns one rank per GPU (`spawn_ranks`, torchrun's environment set for
    each) and the ranks train in one world: rank 0 writes the run, both
    resume-ready. Two GPUs are counted here (`torch.cuda.device_count`
    patched in this process); the spawned ranks are handed `--device cpu`,
    since there is no GPU to run on, and so meet in a gloo world."""
    from neurad_tpu_torch.scripts import train as TTrain

    calls = []
    real_spawn = TTrain.spawn_ranks

    def spawn(argv, world_size):
        calls.append((list(argv), world_size))
        real_spawn(list(argv) + ["--device", "cpu"], world_size)

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(TTrain, "spawn_ranks", spawn)
    argv = ["splatad-tiny", "--max-iterations", "2", "--output-dir", str(tmp_path), "--experiment-name", "r",
            "--set", "pipeline.cap_max=256", "--set", "pipeline.mcmc.cap_max=256", "--dp-set", "image_height=16",
            "--dp-set", "image_width=24", "--dp-set", "num_frames=2"]
    assert TTrain.entrypoint(argv) is None
    assert calls == [(argv, 2)]
    assert sorted(p.name for p in (tmp_path / "r" / "checkpoints").iterdir()) == ["step-000000002.pt"]
    ckpt = torch.load(tmp_path / "r" / "checkpoints" / "step-000000002.pt", weights_only=False)
    assert ckpt["step"] == 2


def test_layout_and_collectives_in_one_process():
    """The global batch's row layout, the shard of a host-identical batch,
    and the checks that refuse a device-less rank or an unlaunched world."""
    rows = [sharding.train_batch_rows(r, 2, 3, 2).tolist() for r in range(2)]
    assert rows == [[0, 1, 2, 6, 7], [3, 4, 5, 8, 9]]
    assert sorted(rows[0] + rows[1]) == list(range(10))
    mesh = sharding.Mesh(group=None, rank=1, world_size=2, device=torch.device("cpu"), backend="gloo")
    tree = {"a": np.arange(6), "b": torch.arange(4).reshape(4, 1), "c": np.arange(3), "d": 7}
    shard = sharding.shard_batch(mesh, tree)
    assert shard["a"].tolist() == [3, 4, 5] and shard["b"].tolist() == [[2], [3]]
    assert shard["c"].tolist() == [0, 1, 2] and shard["d"] == 7
    assert sharding.host_local_seed(5, 0) == 5 and sharding.host_local_seed(5, 2) == 5 + 2 * 7919
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharding.make_mesh(rank=0, world_size=1, init_method="file:///nonexistent/never-used")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))
