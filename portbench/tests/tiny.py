"""Tiny versions of the cells for the CPU tests: the same families, traffic
kinds and readers, at widths and sizes a CPU runs in seconds.

A family's own sizes, limits and planted port faults are in its test-side
module, `portbench/tests/by_family/<family>.py`, found by the configuration's
`family`; a cell whose family has none fails the tests that ask for it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable

from portbench.harness import spec as S

SCENE = {"num_frames": 3, "image_height": 48, "image_width": 72, "focal": 50.4, "lidar_channels": 8,
         "lidar_azimuths": 64}


def family(name: str, root: Path = S.ROOT) -> ModuleType:
    """The test-side module of family `name` in `root`'s benchmark; raises
    LookupError, naming the file to add, where there is none."""
    path = root / "portbench" / "tests" / "by_family" / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"family {name!r} has no test-side module: add portbench/tests/by_family/{name}.py "
                          "with `tiny(config)`, `LIMITS` and the family's planted faults (see portbench/run.py)")
    module_spec = importlib.util.spec_from_file_location(f"portbench_tests_by_family_{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def fault(workload: str, name: str, root: Path = S.ROOT) -> Callable:
    """The port fault `name` that the tests plant in cell `workload`: a
    function of pytest's `monkeypatch` from the cell's family's module;
    raises LookupError, naming the file and the function to add, where that
    module has none."""
    fam = S.load(workload, root).config["family"]
    planted = getattr(family(fam, root), name, None)
    if planted is None:
        raise LookupError(f"cell {workload!r}: family {fam!r} plants no fault {name!r}: add "
                          f"`def {name}(monkeypatch)` to portbench/tests/by_family/{fam}.py")
    return planted


def config(name: str, root: Path = S.ROOT) -> dict:
    """The configuration `name` of the benchmark at a tiny size."""
    c = json.loads((root / "portbench" / "configs" / f"{name}.json").read_text())
    c["scene"] = dict(SCENE)
    return family(c["family"], root).tiny(c)


def cell(workload: str, traffic: dict = None, root: Path = S.ROOT) -> S.Cell:
    """The benchmark's cell `workload` with its configuration made tiny."""
    full = S.load(workload, root)
    full.config = config(full.config_name, root)
    full.limits = getattr(family(full.config["family"], root), "LIMITS", {}).get(workload, full.limits)
    if traffic:
        full.traffic = dict(full.traffic, **traffic)
    return full
