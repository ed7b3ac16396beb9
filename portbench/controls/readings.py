"""The readings each limit of `correct` is set from, on the GPU, at the cell's
own sizes and load:

    python3 portbench/controls/readings.py --workload neurad.sim-camera --seeds 12 --control-seeds 3 \\
        --seconds 4 --json readings.json

One process builds the cell's system once. For each seed it draws the
weights anew, serves a short window of the cell's traffic through the same
driver as a run, and reads the check's numbers for the port; for the first
`--control-seeds` seeds also for each of the driver's variants put in the
port's place on the same requests or steps: the control (the reference in
the precision below the configuration's) and a planted fault (serving: the
actors left where the scene logged them; training: the loss of half the
batch). The lower reading of a number is the largest
the port gives, the upper the smallest a variant gives; `run.py` never runs
them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class Reusing:
    """A family whose system is built once and reseeded for every later
    seed, and whose reference scene is drawn once."""

    def __init__(self, family):
        self.family, self.system, self.scene = family, None, None

    def __getattr__(self, name):
        return getattr(self.family, name)

    def build(self, config, seed, device):
        if self.system is None:
            self.system = self.family.build(config, seed, device)
            self.cameras = self.system.outputs.cameras
        else:
            self.family.reseed(self.system, config, seed, device)
            pipeline = self.system.state.pipeline  # the cameras as built: a request re-poses one of them
            pipeline.outputs.cameras = pipeline.datamanager.outputs.cameras = self.cameras
        return self.system

    def build_train(self, config, seed, device):
        if self.system is None:
            self.system = self.family.build_train(config, seed, device)
        else:
            self.family.reseed_train(self.system, config, seed, device)
        return self.system

    def free_system(self, system) -> None:
        pass

    def _scene(self, config):
        if self.scene is None:
            from portbench.families.common import reference_scene

            self.scene = reference_scene(config)
        return self.scene

    def reference(self, config, system, seed, device, precision="stated", scene=None):
        return self.family.reference(config, system, seed, device, precision, self._scene(config))

    def reference_train(self, config, shapes, seed, device, precision="stated", scene=None):
        return self.family.reference_train(config, shapes, seed, device, precision, self._scene(config))


def readings(cell, seeds, control_seeds: int, seconds: float, device: str, log=print) -> dict:
    """{"program": {seed: {name: reading}}, and the same for each of the
    driver's variants (the control, planted faults), "lower": the largest
    reading of each number over the port's seeds, "upper": {variant: the
    smallest over its seeds}}."""
    import importlib

    from portbench.harness import cell as C
    from portbench.harness.trace import Tracer

    family = Reusing(importlib.import_module(f"portbench.families.{cell.config['family']}"))
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    variants = driver.variants(cell)
    out = {"program": {}, **{v: {} for v in variants}}
    for k, seed in enumerate(seeds):
        ctx = C.Context(cell=cell, family=family, seed=seed, seconds=seconds, tracer=Tracer(False), readers={},
                        device=device, started=time.perf_counter())
        run = driver.run(ctx)
        out["program"][seed] = {name: v for name, (v, _) in run["checks"].items()}
        log(f"[readings] {cell.name} seed {seed}: port {out['program'][seed]} over {run['attempted']} requests")
        for variant in variants if k < control_seeds else ():
            got = driver.control(ctx, variant, scene=ctx.scene)
            out[variant][seed] = {name: v for name, (v, _) in got.items()}
            log(f"[readings] {cell.name} seed {seed}: {variant} {out[variant][seed]}")
    names = sorted(next(iter(out["program"].values())))
    out["lower"] = {n: max(r[n] for r in out["program"].values()) for n in names}
    out["upper"] = {v: {n: min(r[n] for r in out[v].values()) for n in names} for v in variants if out[v]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    import torch

    from portbench.harness import spec as S

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = S.load(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = readings(cell, seeds, args.control_seeds, args.seconds, "cuda")
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"workload": args.workload, "lower": out["lower"], "upper": out.get("upper")}))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
