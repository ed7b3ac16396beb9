"""One run of one cell: the device check, the driver of the cell's traffic,
the per-layer readers, the import guard and the result line."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from typing import Callable, Dict, Optional

from portbench.harness import spec as S
from portbench.harness import trace as T
from portbench.harness.least_work import peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "neurad_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot) is
    JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_reader(name: str, root=S.ROOT):
    """The per-layer metric `name`'s reader module (`portbench/metrics/<name>.py`)."""
    path = S.metric_file(name, root)
    module_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi, None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclasses.dataclass
class Context:
    """What a traffic driver is handed."""

    cell: S.Cell
    family: object
    seed: int
    seconds: float
    tracer: T.Tracer
    readers: Dict[str, object]
    device: str
    started: float
    log: Callable[[str], None] = log

    def sync(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        import torch

        self.sync()
        return int(torch.cuda.max_memory_allocated()) if self.device.startswith("cuda") else 0

    @contextlib.contextmanager
    def window(self):
        """The measured window; with tracing on, the readers' hooks are in
        place and the profiler runs for exactly its length."""
        with contextlib.ExitStack() as stack:
            for reader in self.readers.values():
                if hasattr(reader, "install"):
                    stack.enter_context(reader.install(self.tracer.records))
            with self.tracer.window():
                yield

    def read_trace(self, span_names) -> Dict[str, float]:
        """The per-layer metrics of the traced window (empty when untraced)."""
        context = dict(config=self.cell.config, family=self.family, span_names=tuple(span_names),
                       peaks=peaks(self._device_name()), cell=self.cell.name)
        data = self.tracer.data(context)
        if data is None:
            return {}
        self.trace_data = data
        out = {}
        for name, reader in self.readers.items():
            value = reader.read(data)
            if value is not None:
                out[name] = float(value)
        return out

    def _device_name(self) -> str:
        import torch

        return torch.cuda.get_device_name(0) if self.device.startswith("cuda") else "cpu"


def run_cell(cell: S.Cell, seed: int, seconds: float, trace: bool, device: str, started: float) -> dict:
    """Drive one run of `cell` -> its traffic driver's outcome, with the trace's
    breakdown and device times where traced."""
    family = importlib.import_module(f"portbench.families.{cell.config['family']}")
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    readers = {m["name"]: load_reader(m["name"]) for m in cell.per_layer} if trace else {}
    ctx = Context(cell=cell, family=family, seed=seed, seconds=seconds, tracer=T.Tracer(trace), readers=readers,
                  device=device, started=started)
    outcome = driver.run(ctx)
    data = getattr(ctx, "trace_data", None)
    if data is not None:
        outcome["breakdown"] = T.breakdown(data)
        outcome["busy_s"], outcome["window_s"] = data.busy_s, data.window_s
    return outcome


def _number(x):
    """A reading as JSON holds it: a number, or None where it is not finite."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell: S.Cell, outcome: dict, trace: bool, device: dict) -> dict:
    """The last line: correct, attempted, failed, metrics, device, (breakdown),
    and the numbers compared beside their limits last (a reading that is not
    finite, such as a request that failed, is null there and not correct)."""
    source = cell.per_layer if trace else cell.end_to_end
    values = outcome["per_layer"] if trace else outcome["end_to_end"]
    metrics = {m["name"]: {"value": S.driver_value(values, m["name"]), "unit": m["unit"]} for m in source
               if _number(S.driver_value(values, m["name"])) is not None}
    checks = outcome["checks"]
    correct = bool(checks) and all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    correct = correct and outcome["failed"] == 0 and outcome["attempted"] > 0
    line = {"correct": correct, "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device}
    if trace and "breakdown" in outcome:
        line["breakdown"] = outcome["breakdown"]
    line["checks"] = {name: {"value": _number(v), "limit": limit} for name, (v, limit) in checks.items()}
    return line


def main(args, started: float) -> int:
    try:
        cell = S.load(args.workload)
    except (KeyError, FileNotFoundError) as err:
        log(f"cannot run {args.workload!r}: {err}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the port on a GPU and does not fall back to the CPU")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell asks for {cell.chips} GPUs, {torch.cuda.device_count()} are visible")
        return 3
    log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"TF32 as a user gets it: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": outcome["memory_peak_bytes"], "power_limit_w": power_limit_w()}
    if args.trace:
        device["busy_s"], device["window_s"] = outcome.get("busy_s"), outcome.get("window_s")
    line = result_line(cell, outcome, bool(args.trace), device)
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
