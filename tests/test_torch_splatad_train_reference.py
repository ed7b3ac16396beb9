"""Port SplatAD training (`SplatADPipeline.train_step`, the port's normal
path) against the benchmark's plain reference
(`portbench/reference/splatad_train.py`) on the CPU, and the port's way of
starting training mid-schedule (`init_state(seed, step)`,
`Optimizers.start_at`).

Size: the `splatad-full` configuration made tiny (`portbench/tests/tiny.py`:
a 48x72 frame, an 8x64 scan, 4,096 gaussians drawn by the configuration's
street recipe, 2.2% of them below `min_opacity`) at `splatad-tiny`'s widths
(8 features, 4 appearance, 64 slots a camera tile, 32 a lidar tile),
starting at step 9,997: a camera step, a lidar step, then a step that lands
on step 10,000, after which `mcmc_relocate` and `mcmc_add_noise` run, their
draws taken on both sides from the same state of the port's generator.

On the CPU both sides run the composites' plain forward, so a step's loss is
the same sum on both; the port's backward is the hand-derived one the card's
kernels follow, the reference's autograd through the forward. Tolerances:
losses to 1e-6 relative (the first is equal; later ones follow parameters
that differ in the last bits). First gradients per parameter to 2e-4 of the
gradient's largest entry plus 1e-3 relative: both sum thousands of fp32 terms
per gaussian in other orders, and the backward divides by 1 - alpha >= 0.001.
Parameters after each step: Adam's first update is about lr * sign(g), so an
entry whose gradient is rounding noise may move the other way; every entry is
held to 2.001 lr a step of the reference's and at most 1% of the entries may
lie more than 0.1 lr apart. After the relocation its values are copies of
the targets' and `compute_relocation`'s alternating binomial sums, so 2e-4
relative is added there (as `tests/test_torch_strategy.py` holds the port to
JAX).
"""

import copy
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from neurad_tpu_torch.data.full_image_datamanager import CameraSample  # noqa: E402
from neurad_tpu_torch.engine.optimizers import Optimizers  # noqa: E402
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline  # noqa: E402
from neurad_tpu_torch.utils import profiler as P  # noqa: E402

from portbench.drivers.train import adam_gradients  # noqa: E402
from portbench.families import splatad_train as F  # noqa: E402
from portbench.harness import cell as C  # noqa: E402
from portbench.tests import tiny  # noqa: E402

torch.set_num_threads(1)

SEED = 2**31 + 23
START = 9997  # two steps, then one that lands on 10,000 and refines
TINY_WIDTHS = dict(feature_dim=8, appearance_dim=4, max_per_tile=64, lidar_max_per_tile=32)
GRAD_OF_MAX, GRAD_RTOL = 2e-4, 1e-3
RELOCATION_RTOL = 2e-4


def _config() -> dict:
    c = tiny.config("splatad-full")
    c["train"]["model"] = dict(c["train"]["model"], **TINY_WIDTHS)
    c["train"]["start_step"] = START
    return c


def _draw(dm, want_camera=None):
    """The datamanager's next sample of the wanted kind (any where None) and
    the sampler state it was drawn from."""
    while True:
        state = {"rng": copy.deepcopy(dm.rng_state()), "raster_cache": dict(dm._raster_cache)}
        sample = dm.next_train()
        if want_camera is None or isinstance(sample, CameraSample) == want_camera:
            return sample, state


@pytest.fixture(scope="module")
def run():
    """Three port steps and the reference's on the same samples and draws:
    the port's and the reference's losses, first gradients and parameters
    after each step, and the port's counters over the refine."""
    config = _config()
    system = F.build_train(config, SEED, "cpu")
    dm = system.pipeline.datamanager
    steps = [_draw(dm, True), _draw(dm, False), _draw(dm)]
    port = dict(losses=[], params=[], grads=None)
    recorded = []
    for k, (sample, sampler_state) in enumerate(steps):
        recorded.append((sampler_state, F.generator_state(system)))
        with P.counting() as counters:
            metrics = F.train_step(system, (sample,))
        port["losses"].append(float(metrics["total_loss"]))
        port["params"].append({n: p.detach().clone() for n, p in F.named_parameters(system)})
        if k == 0:
            port["grads"] = adam_gradients(F.named_parameters(system), F.optimizers(system))
    port["counters"] = P.counter_values(counters)
    port["kinds"] = [isinstance(s, CameraSample) for s, _ in steps]
    ref, _ = F.reference_train(config, system.shapes, SEED, "cpu")
    ref_out = dict(losses=[], params=[], grads=None)
    for k, (sampler_state, generator_state) in enumerate(recorded):
        ref_out["losses"].append(ref.step(sampler_state, generator_state))
        ref_out["params"].append({n: p.detach().clone() for n, p in ref.model.named_parameters()})
        if k == 0:
            ref_out["grads"] = ref.first_moments()
    return dict(port=port, ref=ref_out, ref_model=ref, system=system, config=config)


def _lr(system, name: str, step: int) -> float:
    opt = system.state.optimizers
    return opt.schedules[opt.labels[name]](step)


def test_the_steps_cover_both_sensors_and_a_refine(run):
    assert run["port"]["kinds"][:2] == [True, False]
    assert run["system"].state.step == START + 3 == 10000
    assert run["ref_model"].step_count == 10000
    counters = run["port"]["counters"]
    assert counters["mcmc.refines"] == 1 and counters["mcmc.relocated"] > 0, counters


def test_losses_match_the_reference(run):
    port, ref = run["port"]["losses"], run["ref"]["losses"]
    assert port[0] == ref[0]
    np.testing.assert_allclose(port, ref, rtol=1e-6)


def test_first_gradients_match_the_reference(run):
    port, ref = run["port"]["grads"], run["ref"]["grads"]
    reached = 0
    for name, want in ref.items():
        scale = float(want.abs().max())
        got = port.get(name, torch.zeros_like(want))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_OF_MAX * scale + 1e-12, rtol=GRAD_RTOL,
                                   err_msg=name)
        reached += scale > 0
    assert reached >= 12, "gaussians, actors, the RGB decoder and the embedding all reached"


@pytest.mark.parametrize("k", [0, 1, 2], ids=["camera", "lidar", "refine"])
def test_parameters_after_each_step_match_the_reference(run, k):
    system = run["system"]
    got, want = run["port"]["params"][k], run["ref"]["params"][k]
    far = total = 0
    for name, w in want.items():
        lr = _lr(system, name, START)
        rel = RELOCATION_RTOL if k == 2 and name in F_GAUSSIANS else 0.0
        diff = (got[name] - w).abs()
        bound = 2.001 * (k + 1) * lr + rel * w.abs() + 1e-6 * float(w.abs().max())
        assert bool((diff <= bound).all()), (name, float((diff - bound).max()))
        far += int((diff > 0.1 * lr + rel * w.abs() + 1e-6 * float(w.abs().max())).sum())
        total += diff.numel()
    assert far <= 0.01 * total, far / total


F_GAUSSIANS = ("means", "scales", "quats", "opacities", "features")


def test_the_refine_relocated_the_dead_gaussians(run):
    """Slots dead before the last step (one Adam step moves an opacity logit
    by 0.05 at most, so they stay dead through it) moved onto live ones."""
    before, after = run["port"]["params"][1], run["port"]["params"][2]
    dead = torch.sigmoid(before["opacities"] + 0.05) < 0.005
    assert int(dead.sum()) > 0
    assert float((after["means"] - before["means"])[dead].abs().min()) > 0.0, "every dead slot moved"
    assert float((after["means"] - before["means"])[dead].abs().max()) > 0.1, "dead slots moved onto live ones"
    assert int(dead.sum()) <= run["port"]["counters"]["mcmc.relocated"]


def test_training_starts_mid_schedule_through_the_port_state(tmp_path):
    """`init_state(seed, step)` puts the step count and every group's
    schedule at `step`, Adam fresh; a checkpoint of that state restores the
    same counters, and the first update moves the means by their learning
    rate at that step."""
    config = _config()
    system = F.build_train(config, SEED, "cpu")
    pipeline, state = system.pipeline, system.state
    opt = state.optimizers
    assert state.step == START and opt.count == START and set(opt.updates.values()) == {START}
    assert all(not o.state for o in opt.optimizers.values()), "Adam's moments start at zero"
    rates = opt.learning_rates()
    assert rates["means"] == pipeline.config.optimizer_groups["means"].schedule()(START)
    assert rates["means"] < 0.5 * pipeline.config.optimizer_groups["means"].lr, "not step 0's rate"
    pipeline.save_checkpoint(state, tmp_path)
    loaded = pipeline.load_checkpoint(tmp_path, pipeline.init_state(SEED))
    assert loaded.step == START and loaded.optimizers.count == START
    assert loaded.optimizers.updates == opt.updates
    means = pipeline.model.means.detach().clone()
    sample, _ = _draw(pipeline.datamanager, True)
    pipeline.train_step(state, sample)
    moved = (pipeline.model.means.detach() - means).abs()
    ulp = float(torch.finfo(torch.float32).eps * means.abs().max())  # a move is read to the spacing of fp32 there
    assert float(moved.max()) == pytest.approx(rates["means"], abs=ulp)


def test_start_at_keeps_an_accumulating_group_in_step():
    layer = torch.nn.Linear(2, 2)
    from neurad_tpu_torch.engine.optimizers import OptimizerGroupConfig

    opt = Optimizers(layer.named_parameters(), {"fields": OptimizerGroupConfig(lr=1e-2, accum_steps=4)}, ())
    opt.start_at(10)
    assert opt.count == 10 and opt.updates == {"fields": 2} and opt.mini == {"fields": 0}
    assert SplatADPipeline.init_state.__defaults__ == (None, 0)


def test_the_cell_checks_a_frame_then_a_scan_then_a_frame():
    """The configuration's sampler seed: the check's steps, drawn through the
    family's feed as `drivers/train.py` draws them, are a frame (the step whose
    gradients the check compares leaf by leaf), a scan, and a frame."""
    system = F.build_train(_config(), SEED, "cpu")
    feed = F.batches(system)
    try:
        kinds = [isinstance(next(feed)[0][0], CameraSample) for _ in range(3)]
    finally:
        feed.close()
    assert kinds == [True, False, True]


@pytest.mark.parametrize("planted", ["", "camera_backward_altered"], ids=["port", "k3-half-tiles"])
def test_the_check_fails_a_camera_backward_that_leaves_out_half_the_tiles(planted, monkeypatch):
    """The tiny cell through `drivers/train.py` and its check: the port
    passes; with K3 given the gradients of half the frame's tiles only, the
    first step's gradients fail their limit."""
    workload = "splatad-full.train"
    if planted:
        tiny.fault(workload, planted)(monkeypatch)
    cell = tiny.cell(workload)
    outcome = C.run_cell(cell, seed=SEED, seconds=0.4, trace=False, device="cpu", started=time.perf_counter())
    checks = C.result_line(cell, outcome, False, {})["checks"]
    failed = {n for n, c in checks.items() if not c["value"] <= c["limit"]}
    assert ("grad_gap" in failed) if planted else not failed, checks


def test_the_reference_loads_nothing_of_the_port_nor_jax():
    """The reference of the benchmark's check, and its frozen copies, in a
    process of their own: neither the port nor JAX nor the JAX package."""
    import json
    import subprocess

    code = ("import sys, json, portbench.reference.splatad_train\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"neurad_tpu_torch", "neurad_tpu", "jax", "jaxlib", "flax"}
