"""What the two served families share: the scene, the closed-loop server
state around a pipeline, and the check that the port's scene is the
benchmark's."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ServeSystem:
    """The port's system under test and what the check needs after it is gone."""

    state: Any  # neurad_tpu_torch.scripts.closed_loop.ClosedLoopState
    shapes: List[Tuple[str, Tuple[int, ...]]]  # the drawn parameters' names and shapes
    setup: dict = dataclasses.field(default_factory=dict)  # seconds of each set-up stage

    @property
    def outputs(self):
        return self.state.pipeline.outputs


def program_scene(config: dict):
    """The port's synthetic scene of the configuration."""
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig

    return SyntheticDataParserConfig(**config["scene"]).setup().get_dataparser_outputs()


def reference_scene(config: dict):
    """The same scene drawn by the reference's frozen copy."""
    from portbench.reference.port.data.dataparsers.synthetic import SyntheticDataParserConfig

    return SyntheticDataParserConfig(**config["scene"]).setup().get_dataparser_outputs()


def check_same_scene(program_outputs, scene) -> None:
    """The request's camera and actors mean the same on both sides: raises
    where the port's scene differs from the reference's."""
    a, b = program_outputs.cameras, scene.cameras
    for field in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "times"):
        x, y = getattr(a, field), getattr(b, field)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x.cpu(), y.cpu())):
            raise RuntimeError(f"the port's synthetic scene differs from the reference's in cameras.{field}")
    if len(program_outputs.trajectories) != len(scene.trajectories):
        raise RuntimeError("the port's synthetic scene has another number of actors")
    for p, q in zip(program_outputs.trajectories, scene.trajectories):
        for key in ("poses", "timestamps", "dims"):
            if not np.array_equal(np.asarray(p[key]), np.asarray(q[key])):
                raise RuntimeError(f"the port's synthetic scene differs from the reference's in the actors' {key}")


def free(system: ServeSystem) -> None:
    system.state = None
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
