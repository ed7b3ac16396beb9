"""A cell as `BENCHMARK.json` names it, with its configuration, traffic and
limits files found by name."""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent.parent
PKG = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration's file
    traffic_name: str
    traffic: dict  # the traffic mix's file
    limits: dict  # {number compared: its limit} (`portbench/limits/<cell>.json`)
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # ... and with --trace 1


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_file(name: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "traffic" / f"{name}.json"


def limits_file(workload: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "limits" / f"{workload}.json"


def metric_file(name: str, root: Path = ROOT) -> Path:
    """The reader of per-layer metric `name`: `portbench/metrics/<name>.py`,
    else that of the name with its last dotted part left off, and so on
    (`mfu.serve.neurad` is read by `mfu.serve.py`, for the cells it lists)."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = root / "portbench" / "metrics" / (".".join(parts[:k]) + ".py")
        if path.exists():
            return path
    return root / "portbench" / "metrics" / f"{name}.py"


def driver_value(values: dict, name: str):
    """The value a driver reported for metric `name`, or for the name with
    its dotted parts left off from the end (`frames_per_s.neurad` takes the
    driver's `frames_per_s`); None where it reported none."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        key = ".".join(parts[:k])
        if key in values:
            return values[key]
    return None


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of `root`'s BENCHMARK.json; raises KeyError for an
    unknown cell and FileNotFoundError for a missing file."""
    spec = benchmark(root)
    cells: Dict[str, dict] = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(traffic_file(w["traffic"], root).read_text())
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=traffic,
        limits=json.loads(limits_file(workload, root).read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
    )
