"""Family `neurad`: a NeuRAD preset of the port served by `ClosedLoopState`.

The configuration's file gives the preset (`preset`), the model settings
that differ from it (`model`: `sampling`, `field_static`, `field_actor`,
`proposal_static` (a list), `proposal_actor`, `proposal_mlp` as objects of
the settings' fields, other keys as values), the serving chunk and upsample
factor (`serve`), the synthetic scene (`scene`) and the weights' recipe
(`weights`). The reference is built from the same settings by the frozen copy.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Tuple

from portbench.families.common import ServeSystem, program_scene, reference_scene
from portbench.families.common import free as free_system  # noqa: F401  (the drivers' name)
from portbench.harness import weights as W

_SETTINGS = {
    "sampling": "SamplingSettings",
    "field_static": "StaticSettings",
    "field_actor": "ActorSettings",
    "proposal_static": "StaticSettings",
    "proposal_actor": "ActorSettings",
    "proposal_mlp": "MLPProposalSettings",
    "loss": "LossSettings",
}


def model_overrides(model: dict, encoding, neurad) -> dict:
    """The `model` block as keyword arguments of a NeuRADModel, its settings
    built from the given modules (the port's or the reference's)."""
    out = {}
    for key, value in model.items():
        if key not in _SETTINGS:
            out[key] = value
            continue
        name = _SETTINGS[key]
        cls = getattr(encoding, name, None) or getattr(neurad, name)
        out[key] = tuple(cls(**v) for v in value) if isinstance(value, list) else cls(**value)
    return out


def build(config: dict, seed: int, device) -> ServeSystem:
    """The port's server state: the preset's pipeline on the synthetic scene,
    every drawn parameter from the seed."""
    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.fields import neurad_encoding
    from neurad_tpu_torch.models import neurad
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState

    t0 = time.perf_counter()
    outputs = program_scene(config)
    t1 = time.perf_counter()
    cfg = METHODS[config["preset"]]().pipeline
    cfg.model_overrides = dict(cfg.model_overrides, **model_overrides(config.get("model", {}), neurad_encoding, neurad))
    cfg.eval_chunk = int(config["serve"]["eval_chunk"])
    cfg.datamanager.rgb_upsample_factor = int(config["serve"]["rgb_upsample_factor"])
    cfg.seed = int(seed) % 2**31
    pipeline = ADPipeline(outputs, cfg, device=device)
    system = ServeSystem(state=ClosedLoopState(pipeline, device=device), shapes=W.shapes_of(pipeline.model))
    t2 = time.perf_counter()
    reseed(system, config, seed, device)
    system.setup = {"scene_s": t1 - t0, "pipeline_s": t2 - t1, "weights_s": time.perf_counter() - t2}
    return system


def reseed(system: ServeSystem, config: dict, seed: int, device) -> None:
    """Draw the system's weights anew from `seed` (the control readings serve
    many seeds from one build)."""
    W.load(system.state.pipeline.model, W.draw(system.shapes, config["weights"]["rules"], seed, device))


def reference(config: dict, system: ServeSystem, seed: int, device, precision: str = "stated", scene=None):
    """(the plain reference (or, with the configuration's `control` as
    `precision`, the control) on the same weights, its scene); `scene`: the
    reference's scene, drawn anew where None."""
    from portbench.reference.neurad_serve import NeuRADServe
    from portbench.reference.port.fields import neurad_encoding
    from portbench.reference.port.models import neurad

    scene = reference_scene(config) if scene is None else scene
    weights = W.draw(system.shapes, config["weights"]["rules"], seed, device)
    model = model_overrides(config.get("model", {}), neurad_encoding, neurad)
    return NeuRADServe(config["serve"], scene, weights, device, precision=precision, model=model), scene


def _proposal_and_field(arch: dict) -> float:
    """FLOPs a ray of the proposal decoders (or MLPs) and the field's MLPs."""

    def mlp(dims):
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))

    proposal = arch.get("proposal_decoder") or arch["proposal_mlp"]
    return (sum(n * mlp(proposal) for n in arch["proposal_samples"])
            + arch["field_samples"] * (mlp(arch["geo_mlp"]) + mlp(arch["feature_mlp"])))


def _decoder(dec: dict, low: int, up: int) -> float:
    """FLOPs of the upsampling decoder's convolutions over `low` rays."""
    high, k2, c = low * up * up, dec["kernel"] ** 2, dec["hidden"]
    return (2 * low * dec["in"] * c  # stem
            + dec["blocks_low"] * 2 * (2 * low * c * c * k2)  # two k x k convolutions a block
            + 2 * low * c * c * up * up  # the transposed convolution
            + dec["blocks_high"] * 2 * (2 * high * c * c * k2))


def request_flops(config: dict, records: dict) -> List[Tuple[float, str]]:
    """The multiply-adds of one camera request, from the configuration's
    widths: (FLOPs, the dtype whose peak they run at) per part; the dtypes
    are the configuration's (`architecture.dtypes`)."""
    arch, serve = config["architecture"], config["serve"]
    dt = arch["dtypes"]
    h, w = config["scene"]["image_height"], config["scene"]["image_width"]
    up = serve["rgb_upsample_factor"]
    rays = (h // up) * (w // up)
    head = 2 * rays * up * up * arch["decoder"]["hidden"] * 3
    return [(rays * _proposal_and_field(arch), dt["field"]), (_decoder(arch["decoder"], rays, up), dt["decoder"]),
            (head, dt["head"])]


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------


@dataclasses.dataclass
class TrainSystem:
    """The port's training step with its model and optimizer state."""

    pipeline: object  # neurad_tpu_torch.pipelines.ad_pipeline.ADPipeline
    state: object  # its TrainState: step, optimizers, the step generator
    shapes: List[Tuple[str, Tuple[int, ...]]]
    own: dict  # the parameters the model derives from the scene (not drawn), as built
    setup: dict = dataclasses.field(default_factory=dict)


def build_train(config: dict, seed: int, device) -> TrainSystem:
    """The port's pipeline and training state at step 0: the preset's
    pipeline on the synthetic scene with the configuration's batch, its
    parameters drawn from the seed, the optimizers' state fresh."""
    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.engine.optimizers import OptimizerGroupConfig
    from neurad_tpu_torch.fields import neurad_encoding
    from neurad_tpu_torch.models import neurad
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline

    t0 = time.perf_counter()
    outputs = program_scene(config)
    t1 = time.perf_counter()
    train = config["train"]
    cfg = METHODS[config["preset"]]().pipeline
    cfg.model_overrides = dict(cfg.model_overrides, **model_overrides(config.get("model", {}), neurad_encoding, neurad))
    cfg.train_ray_chunk = int(train["train_ray_chunk"])
    cfg.optimizer_groups = {g: OptimizerGroupConfig(**v) for g, v in train["optimizer_groups"].items()}
    dm = cfg.datamanager
    dm.num_cam_patches, dm.patch_size = int(train["num_cam_patches"]), int(train["patch_size"])
    dm.num_lidar_rays, dm.rgb_upsample_factor = int(train["num_lidar_rays"]), int(train["rgb_upsample_factor"])
    dm.num_workers, dm.prefetch = int(train["sampler_threads"]), int(train["prefetch"])
    cfg.seed = int(seed) % 2**31
    pipeline = ADPipeline(outputs, cfg, device=device)
    shapes = W.shapes_of(pipeline.model)
    own = W.undrawn(shapes, config["weights"]["rules"])
    system = TrainSystem(pipeline=pipeline, state=None, shapes=shapes,
                         own={n: p.detach().clone() for n, p in pipeline.model.named_parameters() if n in own})
    t2 = time.perf_counter()
    reseed_train(system, config, seed, device)
    system.setup = {"scene_s": t1 - t0, "pipeline_s": t2 - t1, "weights_s": time.perf_counter() - t2}
    return system


def reseed_train(system: TrainSystem, config: dict, seed: int, device) -> None:
    """The parameters drawn anew from `seed` (the scene's own as built) and a
    fresh training state at step 0."""
    W.load(system.pipeline.model, dict(W.draw(system.shapes, config["weights"]["rules"], seed, device), **system.own))
    system.state = system.pipeline.init_state(int(seed) % 2**63)


def batches(system: TrainSystem):
    """The training feed as `Trainer.train` takes it: (train_step's
    arguments after the state, the batch's rays); closing it stops the
    sampler threads."""
    from neurad_tpu_torch.engine.trainer import train_batches

    return train_batches(system.pipeline)


class SamplerStates:
    """The numpy state of the batch sampler before each batch it draws,
    while entered: the datamanager's `_sample_with_rng` is wrapped on the
    instance (its sampler threads call it there); `of(args)` gives the state
    that the batch of `train_step`'s arguments was drawn from."""

    def __init__(self, system: TrainSystem):
        self.dm = system.pipeline.datamanager
        self.states: dict = {}

    def __enter__(self):
        original = getattr(self.dm, "_sample_with_rng", None)
        if original is None:
            raise RuntimeError("the port's datamanager no longer has _sample_with_rng, which the check replays")

        def wrapper(rng):
            state = copy.deepcopy(rng.bit_generator.state)
            bundle, batch = original(rng)
            self.states[id(bundle)] = (bundle, state)  # the bundle is held so that its id is not reused
            return bundle, batch

        self.dm._sample_with_rng = wrapper
        return self

    def __exit__(self, *exc):
        del self.dm._sample_with_rng
        return False

    def of(self, args) -> dict:
        return self.states[id(args[0])][1]


def sampler_states(system: TrainSystem) -> SamplerStates:
    return SamplerStates(system)


def train_step(system: TrainSystem, args) -> dict:
    system.state, metrics = system.pipeline.train_step(system.state, *args)
    return metrics


def generator_state(system: TrainSystem):
    """The state of the step's generator (the draws of the next step)."""
    return system.state.generator.get_state()


def named_parameters(system: TrainSystem):
    return system.pipeline.model.named_parameters()


def optimizers(system: TrainSystem) -> dict:
    """{group: torch optimizer} of the training state."""
    return system.state.optimizers.optimizers


def reference_train(config: dict, shapes, seed: int, device, precision: str = "stated", scene=None):
    """(the plain reference's trainer (or, with the configuration's
    `control` as `precision`, the control's) on the same weights, its
    scene)."""
    from portbench.reference.neurad_train import NeuRADTrain
    from portbench.reference.port.fields import neurad_encoding
    from portbench.reference.port.models import neurad

    scene = reference_scene(config) if scene is None else scene
    weights = W.draw(shapes, config["weights"]["rules"], seed, device)
    model = model_overrides(config.get("model", {}), neurad_encoding, neurad)
    return NeuRADTrain(config["train"], scene, weights, device, precision=precision, model=model), scene


def step_flops(config: dict, records: dict) -> List[Tuple[float, str]]:
    """The FLOPs of one training step from the configuration's widths: the
    forward and backward (three times the forward) of the MLPs over the
    batch's rays, of the decoders over its camera patches and lidar rays,
    and the VGG19 loss (a forward of the rendered and of the true patches,
    the backward of the rendered), (FLOPs, dtype) per part."""
    arch, train = config["architecture"], config["train"]
    dt = arch["dtypes"]
    d, up, patches = train["patch_size"], train["rgb_upsample_factor"], train["num_cam_patches"]
    rays = patches * d * d + train["num_lidar_rays"]

    def mlp(dims):
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))

    high = patches * (d * up) ** 2
    head = 2 * high * arch["decoder"]["hidden"] * 3
    side = d * up
    vgg = sum(2 * patches * (side // div) ** 2 * cin * cout * 9 for cin, cout, div in arch["vgg19"])
    return [(3 * rays * _proposal_and_field(arch), dt["field"]),
            (3 * train["num_lidar_rays"] * mlp(arch["lidar_mlp"]), dt["field"]),
            (3 * _decoder(arch["decoder"], patches * d * d, up), dt["decoder"]), (3 * head, dt["head"]),
            (4 * vgg, dt["vgg19"])]
