"""Family `splatad`: a SplatAD preset of the port served by `ClosedLoopState`.

The configuration's file gives the preset (`preset`), the gaussians' capacity
and model settings (`serve.cap_max`, `serve.model`: fields of `SplatADConfig`),
the synthetic scene (`scene`) and the weights' recipe (`weights`). The
gaussians are drawn from the seed like every other weight; `weights.actors`
says which share of them belong to the actors (`share`, their means drawn
inside the actor's box, in its frame).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import torch

from portbench.families.common import ServeSystem, program_scene, reference_scene
from portbench.families.common import free as free_system  # noqa: F401  (the drivers' name)
from portbench.harness import weights as W

_SALT = 0xAC7_0125


def gaussian_ids(config: dict, cap: int, dims, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the gaussians' actor ids [cap] int32, n_actors for static ones; the
    actor gaussians' means [n, 3] in their box's frame)."""
    n_actors = len(dims)
    n = int(cap * float(config["weights"]["actors"]["share"])) if n_actors else 0
    ids = torch.full((cap,), n_actors, dtype=torch.int32, device=device)
    ids[:n] = (torch.arange(n, device=device) % max(n_actors, 1)).to(torch.int32)
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ _SALT) % 2**63)
    half = torch.as_tensor(dims, dtype=torch.float32, device=device)[ids[:n].long()] / 2.0
    means = (2.0 * torch.rand((n, 3), generator=gen, device=device) - 1.0) * half
    return ids, means


def _draw(config: dict, shapes, dims, seed: int, device):
    weights = W.draw(shapes, config["weights"]["rules"], seed, device)
    ids, actor_means = gaussian_ids(config, weights["means"].shape[0], dims, seed, device)
    weights["means"][: actor_means.shape[0]] = actor_means
    return weights, ids


def _dims(outputs) -> list:
    return [list(map(float, t["dims"])) for t in outputs.trajectories]


def build(config: dict, seed: int, device) -> ServeSystem:
    """The port's server state: the preset's pipeline on the synthetic scene,
    its gaussians and decoders drawn from the seed."""
    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState

    t0 = time.perf_counter()
    outputs = program_scene(config)
    t1 = time.perf_counter()
    cfg = METHODS[config["preset"]]().pipeline
    serve = config["serve"]
    cfg.cap_max = int(serve["cap_max"])
    cfg.model = dataclasses.replace(cfg.model, **serve.get("model", {}))
    cfg.seed = int(seed) % 2**31
    pipeline = SplatADPipeline(outputs, cfg, device=device)
    system = ServeSystem(state=ClosedLoopState(pipeline, device=device), shapes=W.shapes_of(pipeline.model))
    t2 = time.perf_counter()
    reseed(system, config, seed, device)
    system.setup = {"scene_s": t1 - t0, "pipeline_s": t2 - t1, "weights_s": time.perf_counter() - t2}
    return system


def reseed(system: ServeSystem, config: dict, seed: int, device) -> None:
    """Draw the system's gaussians and weights anew from `seed`."""
    model = system.state.pipeline.model
    weights, ids = _draw(config, system.shapes, _dims(system.outputs), seed, device)
    W.load(model, weights)
    with torch.no_grad():
        model.gauss_ids.copy_(ids)


def reference(config: dict, system: ServeSystem, seed: int, device, precision: str = "stated", scene=None):
    """(the plain reference (or, with the configuration's `control` as
    `precision`, the control) on the same gaussians and weights, its scene);
    `scene`: drawn anew where None."""
    from portbench.reference.splatad_serve import SplatADServe

    scene = reference_scene(config) if scene is None else scene
    weights, ids = _draw(config, system.shapes, _dims(scene), seed, device)
    return SplatADServe(config["serve"], scene, weights, ids, device, precision=precision), scene


def request_flops(config: dict, records: dict) -> List[Tuple[float, str]]:
    """The RGB decoder's convolutions a request, from the configuration's
    widths, and the camera composite's operations (one launch a request) as
    counted from the traced launches' inputs, where they were recorded."""
    from portbench.harness import launches

    arch = config["architecture"]["decoder"]
    px = config["scene"]["image_height"] * config["scene"]["image_width"]
    k2, c, i = arch["kernel"] ** 2, arch["hidden"], arch["in"]
    # block 0: conv1 in -> c, conv2 c -> c, the 1x1 skip in -> c; every further block two c -> c
    convs = 2 * px * (k2 * i * c + k2 * c * c + i * c) + (arch["blocks"] - 1) * 2 * (2 * px * k2 * c * c)
    head = 2 * px * c * arch["out"]
    parts = [(convs, "bf16"), (head, "fp32")]
    counts = launches.counted(records, "k2")
    if counts:
        parts.append((sum(ops for _, ops in counts) / len(counts), "fp32"))
    return parts
