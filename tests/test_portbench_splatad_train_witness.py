"""The benchmark's plain reference of SplatAD training
(`portbench/reference/splatad_train.py`) held against an independent witness,
the JAX package's `SplatADPipeline`, on the CPU.

The reference is built on a frozen copy of the port's modules, so a fault the
port had when the copy was made would be in the reference too; the JAX
package shares no code with either. Both start from the same parameters
(JAX's, carried across by `neurad_tpu_torch.params_from_jax`, a test helper
here), a tenth of the gaussians made dead, at step 9,997 of the schedules
(JAX: the state's step and every group's `optax` schedule count; the
reference: `train.start_step`), Adam's moments at zero on both sides. The
reference draws each step's sample again from the state of JAX's sampler
(the two datamanagers draw alike from numpy's generator), and takes the
relocation's targets and noise that JAX's key gives. Three steps: a camera
frame, a lidar scan, then a step landing on 10,000, after which the MCMC
relocation and its noise run.

Size: a 64x96 frame (24 tiles of 16 pixels) and a 16x180 scan in 20 x
14-degree tiles (54), 3,000 gaussians: under 64 tiles the JAX package's
Pallas composites run, in interpret mode. Both decoders compute in fp32
(JAX's module patched, as `tests/test_torch_splatad_train.py` does; the
reference's `compute_dtype` set), so the comparison is of fp32 sums in other
orders. Tolerances: losses 2e-5 relative; first gradients (Adam's first
moments over 1 - beta1 on both sides) per parameter within 2e-4 of the
gradient's largest entry plus 1e-3 relative (the composites' backward
divides by 1 - alpha >= 0.001); parameters after each step within 2.001 lr a
step of JAX's (Adam's first update is about lr * sign(g), and a gradient
that is rounding noise may change sign), at most 1% of the entries more than
0.1 lr apart, and 2e-4 relative added after the relocation
(`compute_relocation`'s alternating binomial sums, as
`tests/test_torch_strategy.py` holds the port).
"""

import copy
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth  # noqa: E402
from neurad_tpu.data.full_image_datamanager import CameraSample as JCameraSample  # noqa: E402
from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManagerConfig as JDMC  # noqa: E402
from neurad_tpu.model_components.strategy import MCMCStrategyConfig as JMCMC  # noqa: E402
from neurad_tpu.models import splatad as JS  # noqa: E402
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipeline as JPipe  # noqa: E402
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipelineConfig as JPipeCfg  # noqa: E402
from neurad_tpu_torch import params_from_jax as bridge  # noqa: E402

from portbench.reference.port.data.dataparsers.synthetic import SyntheticDataParserConfig as RSynth  # noqa: E402
from portbench.reference.splatad_train import GAUSSIAN_KEYS, SplatADTrain  # noqa: E402

torch.set_num_threads(1)

SCENE = dict(num_frames=4, image_height=64, image_width=96, focal=48.0, lidar_channels=16, lidar_azimuths=180)
MODEL = dict(max_per_tile=256, near_plane=2.0, lidar_tile_azim=20.0, lidar_tile_elev=14.0, lidar_max_per_tile=32,
             lidar_pts_per_tile=64)
CAP, MAX_POINTS, START = 3000, 4096, 9997
GROUPS = {"means": {"lr": 1.6e-4, "lr_final": 1.6e-6, "max_steps": 30000}, "features": {"lr": 2.5e-3},
          "opacities": {"lr": 5e-2}, "scales": {"lr": 5e-3}, "quats": {"lr": 1e-3},
          "fields": {"lr": 1e-3, "weight_decay": 1e-6},
          "trajectory_opt": {"lr": 1e-3, "lr_final": 1e-4, "warmup_steps": 2500},
          "camera_opt": {"lr": 1e-4, "lr_final": 1e-5, "warmup_steps": 2500}}
GRAD_OF_MAX, GRAD_RTOL, RELOCATION_RTOL = 2e-4, 1e-3, 2e-4


def _at_step(opt_state, step: int):
    """optax's state with every schedule's count at `step` (Adam's own count and moments as they are)."""
    sched = lambda s: isinstance(s, optax.ScaleByScheduleState)  # noqa: E731
    return jax.tree.map(lambda s: s._replace(count=jnp.asarray(step, s.count.dtype)) if sched(s) else s, opt_state,
                        is_leaf=sched)


def _first_grads(jstate, labels: dict) -> dict:
    """Each parameter's gradient as JAX's Adam got it at its first update:
    its first moment over 1 - beta1, under the port's parameter names."""
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    out = {}
    for group, inner in jstate.opt_state.inner_states.items():
        adam = next(s for s in jax.tree.leaves(inner, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
        tree = jax.tree.map(lambda m, p: np.zeros_like(p) if masked(m) else np.asarray(m), adam.mu, jstate.params,
                            is_leaf=masked)
        for name, value in bridge.splatad_params_from_flax(tree).items():
            if labels.get(name) == group:
                out[name] = value / 0.1
    return out


def _next(dm, want_camera=None):
    """JAX's datamanager's next sample of the wanted kind (any where None)
    and the sampler state it was drawn from, in the reference's form."""
    while True:
        state = {"rng": copy.deepcopy(dm.rng_state()), "raster_cache": dict(dm._raster_cache)}
        sample = dm.next_train()
        if want_camera is None or isinstance(sample, JCameraSample) == want_camera:
            return sample, state


def _relocation_draws(jp, jstate):
    """The targets and noise that `_refine` draws from the state's key (its
    split, then `mcmc_relocate`'s and `mcmc_add_noise`'s own)."""
    _, r1, r2 = jax.random.split(jstate.rng, 3)
    op = jax.nn.sigmoid(jstate.params["params"]["opacities"])
    probs = jnp.where(op < jp.config.mcmc.min_opacity, 0.0, op)
    probs = probs / jnp.clip(probs.sum(), 1e-12, None)
    targets = np.array(jax.random.choice(jax.random.split(r1)[0], CAP, shape=(CAP,), p=probs))
    return torch.from_numpy(targets), torch.from_numpy(np.array(jax.random.normal(r2, (CAP, 3))))


@pytest.fixture(scope="module")
def walked():
    mp = pytest.MonkeyPatch()  # the JAX decoders in fp32 while the module's steps run
    mp.setattr(JS, "RGBDecoderCNN", functools.partial(JS.RGBDecoderCNN, compute_dtype=jnp.float32))
    mp.setattr(JS, "MLP", functools.partial(JS.MLP, compute_dtype=jnp.float32))
    try:
        jp = JPipe(JSynth(**SCENE).setup().get_dataparser_outputs(),
                   JPipeCfg(model=JS.SplatADConfig(**MODEL), mcmc=JMCMC(cap_max=CAP), cap_max=CAP,
                            datamanager=JDMC(max_lidar_points=MAX_POINTS)))
        jstate = jp.init_state()
        p = dict(jstate.params["params"])
        dead = np.random.default_rng(0).permutation(CAP)[: CAP // 10]
        p["opacities"] = p["opacities"].at[dead].set(-8.0)
        jstate = jstate.replace(params={**jstate.params, "params": p}, step=jnp.asarray(START, jstate.step.dtype),
                                opt_state=_at_step(jstate.opt_state, START))

        train = {"start_step": START, "model": MODEL, "mcmc": {"cap_max": CAP},
                 "datamanager": {"max_lidar_points": MAX_POINTS}, "optimizer_groups": GROUPS}
        weights = bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params))
        ids = torch.from_numpy(np.asarray(jp.model.init_data.ids)).to(torch.int32)
        ref = SplatADTrain(train, RSynth(**SCENE).setup().get_dataparser_outputs(), weights, ids, "cpu")
        for m in ref.model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float32

        out = dict(jlosses=[], rlosses=[], jparams=[], rparams=[], kinds=[], ref=ref, jp=jp)
        for k, kind in enumerate((True, False, None)):
            sample, sampler_state = _next(jp.datamanager, kind)
            out["kinds"].append(isinstance(sample, JCameraSample))
            refine, jp._maybe_refine = jp._maybe_refine, lambda state: state  # the step alone, then the refine
            try:
                jstate, metrics = jp.train_step(jstate, sample)
            finally:
                jp._maybe_refine = refine
            draws = None
            if int(jstate.step) == 10000:
                draws = _relocation_draws(jp, jstate)
                jstate = jp._maybe_refine(jstate)
            out["jlosses"].append(float(metrics["total_loss"]))
            out["rlosses"].append(ref.step(sampler_state, draws=draws))
            out["jparams"].append(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params)))
            out["rparams"].append({n: q.detach().clone() for n, q in ref.model.named_parameters()})
            if k == 0:
                out["jgrads"] = _first_grads(jstate, ref.optimizers.labels)
                out["rgrads"] = ref.first_moments()
        out["dead"] = torch.from_numpy(dead)
        return out
    finally:
        mp.undo()


def test_the_walk_covers_both_sensors_and_a_relocation(walked):
    assert walked["kinds"][:2] == [True, False]
    assert walked["ref"].step_count == 10000


def test_reference_losses_match_jax(walked):
    np.testing.assert_allclose(walked["rlosses"], walked["jlosses"], rtol=2e-5)


def test_reference_first_gradients_match_jax(walked):
    want, got = walked["jgrads"], walked["rgrads"]
    reached = 0
    for name, w in want.items():
        scale = float(w.abs().max())
        g = got.get(name, torch.zeros_like(w))
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_OF_MAX * scale + 1e-12, rtol=GRAD_RTOL,
                                   err_msg=name)
        reached += scale > 0
    assert reached >= 12


@pytest.mark.parametrize("k", [0, 1, 2], ids=["camera", "lidar", "relocation"])
def test_reference_parameters_match_jax_after_each_step(walked, k):
    ref = walked["ref"]
    opt = ref.optimizers
    want, got = walked["jparams"][k], walked["rparams"][k]
    far = total = 0
    for name, g in got.items():
        w = want[name]
        lr = opt.schedules[opt.labels[name]](START)
        rel = RELOCATION_RTOL if k == 2 and name in GAUSSIAN_KEYS else 0.0
        diff = (g - w).abs()
        floor = rel * w.abs() + 1e-6 * float(w.abs().max())
        assert bool((diff <= 2.001 * (k + 1) * lr + floor).all()), name
        far += int((diff > 0.1 * lr + floor).sum())
        total += diff.numel()
    assert far <= 0.01 * total, far / total
    if k == 2:
        moved = (got["means"] - walked["rparams"][1]["means"])[walked["dead"]].abs().max()
        assert float(moved) > 0.1, "the dead gaussians were relocated"
