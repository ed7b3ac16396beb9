"""Family `splatad_train`: a SplatAD preset of the port trained as the
trainer trains it, one full camera frame or one full lidar scan a step,
through `engine/trainer.train_batches` and `SplatADPipeline.train_step`.

The configuration's file gives the preset (`preset`), the training settings
(`train`: `start_step`, `cap_max`, the fields of `SplatADConfig` that differ
from the preset's (`model`), of `MCMCStrategyConfig` (`mcmc`), of
`FullImageLidarDataManagerConfig` (`datamanager`), and the optimizer groups),
the synthetic scene (`scene`), the widths its FLOPs are counted from
(`architecture`) and the weights' recipe (`weights`, drawn as `splatad`'s
served gaussians are, `families/splatad.py`). Training starts at
`train.start_step` through the port's own state (`init_state(seed, step)`:
the step count and the optimizers' schedules there, Adam's moments at zero).

The run's seed draws the gaussians, the decoders and the densification's
generator. The datamanager's sampler starts from the configuration's
`train.sampler_seed`, the same in every run, so that every run trains on the
same sequence of frames and scans, drawn at random as the preset draws them:
a frame counts 32 times the rays of a scan and takes about as long, so with
the sampler seeded by the run a window's rays followed the binomial count of
its frames (a set of 6 seeds spread 15% in rays/s). The configuration picks
a seed whose first draws are a frame, a scan and a frame: the check reads
the first step's gradients, so the camera's backward is the one compared
leaf by leaf, and the later losses follow both sensors' updates.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import time
from typing import List, Tuple

import numpy as np

from portbench.families.common import program_scene, reference_scene
from portbench.families.splatad import _dims, _draw
from portbench.harness import weights as W


@dataclasses.dataclass
class TrainSystem:
    """The port's training step with its model and optimizer state."""

    pipeline: object  # neurad_tpu_torch.pipelines.splatad_pipeline.SplatADPipeline
    state: object  # its TrainState: step, optimizers, the densification's generator
    shapes: List[Tuple[str, Tuple[int, ...]]]
    scene_own: dict  # the parameters the model derives from the scene (not drawn), as built
    own: dict = dataclasses.field(default_factory=dict)  # those and the means as loaded (the actors' in their boxes)
    setup: dict = dataclasses.field(default_factory=dict)


def pipeline_config(config: dict):
    """The preset's `SplatADPipelineConfig` with the configuration's training
    settings."""
    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.engine.optimizers import OptimizerGroupConfig

    train = config["train"]
    cfg = METHODS[config["preset"]]().pipeline
    cfg.cap_max = int(train["cap_max"])
    cfg.model = dataclasses.replace(cfg.model, **train.get("model", {}))
    cfg.mcmc = dataclasses.replace(cfg.mcmc, **train.get("mcmc", {}))
    cfg.datamanager = dataclasses.replace(cfg.datamanager, **train.get("datamanager", {}))
    cfg.optimizer_groups = {g: OptimizerGroupConfig(**v) for g, v in train["optimizer_groups"].items()}
    return cfg


def build_train(config: dict, seed: int, device) -> TrainSystem:
    """The port's pipeline and training state at `train.start_step`: the
    preset's pipeline on the synthetic scene, its gaussians and decoders drawn
    from the seed, the optimizers fresh with their schedules at that step."""
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline

    if "step" not in inspect.signature(SplatADPipeline.init_state).parameters:
        raise RuntimeError("the port's SplatADPipeline.init_state takes no start step: it cannot train mid-schedule")
    t0 = time.perf_counter()
    outputs = program_scene(config)
    t1 = time.perf_counter()
    pipeline = SplatADPipeline(outputs, pipeline_config(config), device=device)
    shapes = W.shapes_of(pipeline.model)
    kept = W.undrawn(shapes, config["weights"]["rules"])
    system = TrainSystem(pipeline=pipeline, state=None, shapes=shapes,
                         scene_own={n: p.detach().clone() for n, p in pipeline.model.named_parameters() if n in kept})
    t2 = time.perf_counter()
    reseed_train(system, config, seed, device)
    system.setup = {"scene_s": t1 - t0, "pipeline_s": t2 - t1, "weights_s": time.perf_counter() - t2}
    return system


def reseed_train(system: TrainSystem, config: dict, seed: int, device) -> None:
    """The gaussians and weights drawn anew from `seed` (the scene's own as
    built), the sampler back at the start of the sequence of
    `train.sampler_seed`, a fresh training state at `train.start_step` with
    its generator seeded by `seed`."""
    import torch

    pipeline = system.pipeline
    weights, ids = _draw(config, system.shapes, _dims(pipeline.outputs), seed, device)
    W.load(pipeline.model, dict(weights, **system.scene_own))
    with torch.no_grad():
        pipeline.model.gauss_ids.copy_(ids)
    system.own = dict(system.scene_own, means=weights["means"])
    sampler = np.random.default_rng(int(config["train"]["sampler_seed"]))
    pipeline.datamanager.set_rng_state(sampler.bit_generator.state)
    system.state = pipeline.init_state(int(seed) % 2**63, step=int(config["train"]["start_step"]))


def _rays(system: TrainSystem, sample) -> int:
    """The rays a sample trains: a frame's pixels at the resolution its step
    trains, a scan's valid points (host numbers: nothing waits for the card)."""
    from neurad_tpu_torch.data.full_image_datamanager import CameraSample

    if isinstance(sample, CameraSample):
        s = system.pipeline._downscale_sample(sample, system.state.step)
        return int(s.width) * int(s.height)
    return int(np.count_nonzero(sample.valid))


def batches(system: TrainSystem):
    """The training feed as `Trainer.train` takes it (`train_batches`: one
    frame or scan a step, drawn on the host) -> (train_step's arguments after
    the state, the sample's rays)."""
    from neurad_tpu_torch.engine.trainer import train_batches

    feed = train_batches(system.pipeline)
    try:
        for args, _ in feed:
            yield args, _rays(system, args[0])
    finally:
        feed.close()


class SamplerStates:
    """The datamanager's sampler state before each sample it draws, while
    entered: its `next_train` is wrapped on the instance; `of(args)` gives
    the state that the sample of `train_step`'s arguments was drawn from:
    numpy's generator state and the padded scans drawn so far, from which a
    later draw of the same scan takes its points."""

    def __init__(self, system: TrainSystem):
        self.dm = system.pipeline.datamanager
        self.states: dict = {}

    def __enter__(self):
        dm = self.dm
        if not all(hasattr(dm, a) for a in ("next_train", "rng_state", "_raster_cache")):
            raise RuntimeError("the port's datamanager no longer has next_train, rng_state and _raster_cache, "
                               "which the check replays")
        original = dm.next_train

        def wrapper():
            state = {"rng": copy.deepcopy(dm.rng_state()), "raster_cache": dict(dm._raster_cache)}
            sample = original()
            self.states[id(sample)] = (sample, state)  # the sample is held so that its id is not reused
            return sample

        dm.next_train = wrapper
        return self

    def __exit__(self, *exc):
        del self.dm.next_train
        return False

    def of(self, args) -> dict:
        return self.states[id(args[0])][1]


def sampler_states(system: TrainSystem) -> SamplerStates:
    return SamplerStates(system)


def train_step(system: TrainSystem, args) -> dict:
    system.state, metrics = system.pipeline.train_step(system.state, *args)
    return metrics


def generator_state(system: TrainSystem):
    """The state of the densification's generator (the draws of the next refine)."""
    return system.state.generator.get_state()


def named_parameters(system: TrainSystem):
    return system.pipeline.model.named_parameters()


def optimizers(system: TrainSystem) -> dict:
    """{group: torch optimizer} of the training state."""
    return system.state.optimizers.optimizers


def reference_train(config: dict, shapes, seed: int, device, precision: str = "stated", scene=None):
    """(the plain reference's trainer (or, with the configuration's `control`
    as `precision`, the control's) on the same gaussians and weights, its
    scene)."""
    from portbench.reference.splatad_train import SplatADTrain

    scene = reference_scene(config) if scene is None else scene
    weights, ids = _draw(config, shapes, _dims(scene), seed, device)
    return SplatADTrain(config["train"], scene, weights, ids, device, precision=precision), scene


def step_flops(config: dict, records: dict) -> List[Tuple[float, str]]:
    """The FLOPs of the mean training step from the configuration's widths:
    the forward and backward (three times the forward) of the RGB decoder's
    convolutions over a frame (bf16) and of its head (fp32), weighted by
    `camera_fraction`, and of the lidar decoder's MLP over a padded scan
    (bf16), weighted by the rest, (FLOPs, dtype) per part."""
    arch, dm = config["architecture"], config["train"]["datamanager"]
    dec = arch["decoder"]
    px = config["scene"]["image_height"] * config["scene"]["image_width"]
    k2, c, i = dec["kernel"] ** 2, dec["hidden"], dec["in"]
    # block 0: conv1 in -> c, conv2 c -> c, the 1x1 skip in -> c; every further block two c -> c
    convs = 2 * px * (k2 * i * c + k2 * c * c + i * c) + (dec["blocks"] - 1) * 2 * (2 * px * k2 * c * c)
    head = 2 * px * c * dec["out"]
    dims = arch["lidar_decoder"]
    lidar = 2 * dm["max_lidar_points"] * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    cam = float(dm["camera_fraction"])
    return [(3 * cam * convs, "bf16"), (3 * cam * head, "fp32"), (3 * (1.0 - cam) * lidar, "bf16")]
