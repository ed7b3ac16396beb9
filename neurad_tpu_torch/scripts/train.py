"""Train a method on a dataset (torch port of `neurad_tpu/scripts/train.py`,
the SplatAD branch on the synthetic scene).

    python -m neurad_tpu_torch.scripts.train splatad-tiny --max-iterations 100 --output-dir outputs
    python -m neurad_tpu_torch.scripts.train splatad --set pipeline.cap_max=200000 --dp-set image_height=480
    python -m neurad_tpu_torch.scripts.train splatad --load-dir outputs/<run>      # resume

Runs on a CUDA device unless `--device cpu` is given. A run directory holds
`config.json` (method, dataparser settings, the pipeline's configuration) and
`checkpoints/step-<step>.pt`; `load_run` rebuilds a pipeline from it. The
viewer, the periodic eval and the ray-based methods are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig
from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig
from neurad_tpu_torch.models.splatad import SplatADConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig, TrainState


@dataclasses.dataclass
class TrainerConfig:
    max_num_iterations: int = 30001
    steps_per_save: int = 2000
    steps_per_log: int = 100


@dataclasses.dataclass
class MethodConfig:
    method_name: str
    trainer: TrainerConfig
    pipeline: SplatADPipelineConfig
    dataparser: str = "synthetic"


def _splatad(strategy: str = "mcmc") -> MethodConfig:
    name = "splatad" if strategy == "mcmc" else "splatad-default"
    return MethodConfig(name, TrainerConfig(), SplatADPipelineConfig(strategy=strategy))


def _splatad_tiny() -> MethodConfig:
    return MethodConfig(
        "splatad-tiny",
        TrainerConfig(max_num_iterations=100, steps_per_save=10**9, steps_per_log=10),
        SplatADPipelineConfig(
            datamanager=FullImageLidarDataManagerConfig(max_lidar_points=512),
            model=SplatADConfig(num_downscales=0, feature_dim=8, appearance_dim=4, max_per_tile=64, lidar_max_per_tile=32),
            mcmc=MCMCStrategyConfig(cap_max=2048, refine_start_iter=10, refine_every=25),
            cap_max=2048,
        ),
    )


METHODS: Dict[str, Callable[[], MethodConfig]] = {
    "splatad": _splatad,
    "splatad-default": lambda: _splatad("default"),
    "splatad-tiny": _splatad_tiny,
}


def _parse(value: str, current):
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def _with_override(obj, dotted: str, value: str):
    """`obj` with obj.a.b.c = parsed(value) for '--set a.b.c=value'; frozen
    configs on the way are replaced, the others set in place."""
    head, _, rest = dotted.partition(".")
    cur = getattr(obj, head)
    new = _with_override(cur, rest, value) if rest else _parse(value, cur)
    if obj.__dataclass_params__.frozen:
        return dataclasses.replace(obj, **{head: new})
    setattr(obj, head, new)
    return obj


def write_run_config(run_dir, method: str, dp_cfg: SyntheticDataParserConfig, pipeline_cfg: SplatADPipelineConfig,
                     seed: int, overrides=()) -> Path:
    """Start a run directory: `config.json` holds what `load_run` needs to
    rebuild the scene and the pipeline."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps({
        "method": method, "dataparser": "synthetic", "dataparser_config": dataclasses.asdict(dp_cfg),
        "pipeline": pipeline_cfg.to_dict(), "overrides": list(overrides), "seed": seed,
    }, indent=2))
    return run_dir


def load_run(run_dir, device="cuda", with_state: bool = False) -> Tuple[SplatADPipeline, Optional[TrainState]]:
    """Rebuild the pipeline of a run directory and load its newest checkpoint
    (and, with `with_state`, the training state to resume from)."""
    run_dir = Path(run_dir)
    meta = json.loads((run_dir / "config.json").read_text())
    if meta["dataparser"] != "synthetic":
        raise NotImplementedError(f"dataparser {meta['dataparser']!r} is not ported")
    outputs = SyntheticDataParserConfig(**meta["dataparser_config"]).setup().get_dataparser_outputs()
    pipeline = SplatADPipeline(outputs, SplatADPipelineConfig.from_dict(meta["pipeline"]), device=device)
    state = pipeline.init_state() if with_state else None
    pipeline.load_checkpoint(run_dir / "checkpoints", state)
    return pipeline, state


def entrypoint(argv=None) -> Tuple[SplatADPipeline, TrainState]:
    parser = argparse.ArgumentParser(description="Train a neurad_tpu_torch method")
    parser.add_argument("method", help=f"method name ({', '.join(METHODS)})")
    parser.add_argument("--dataparser", default=None, help="dataparser name (only 'synthetic' is ported)")
    parser.add_argument("--max-iterations", type=int, default=None)
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--experiment-name", default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--load-dir", default=None, help="run directory of a previous run to resume from")
    parser.add_argument("--set", action="append", default=[], metavar="PATH=VALUE",
                        help="config override, e.g. trainer.steps_per_log=50 or pipeline.model.tile_size=8")
    parser.add_argument("--dp-set", action="append", default=[], metavar="KEY=VALUE",
                        help="dataparser config override (e.g. image_height=480)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.method not in METHODS:
        raise SystemExit(f"unknown method {args.method!r}; ported methods: {', '.join(METHODS)}")

    cfg = METHODS[args.method]()
    if args.max_iterations is not None:
        cfg.trainer.max_num_iterations = args.max_iterations
    for ov in args.set:
        path, _, value = ov.partition("=")
        cfg = _with_override(cfg, path, value)
    cfg.pipeline.seed = args.seed
    dataparser = args.dataparser or cfg.dataparser
    if dataparser != "synthetic":
        raise NotImplementedError(f"dataparser {dataparser!r} is not ported")
    dp_cfg = SyntheticDataParserConfig()
    for ov in args.dp_set:
        key, _, value = ov.partition("=")
        setattr(dp_cfg, key, _parse(value, getattr(dp_cfg, key)))

    if args.load_dir:
        run_dir = Path(args.load_dir)
        pipeline, state = load_run(run_dir, device=device, with_state=True)
    else:
        exp_name = args.experiment_name or f"{args.method}-{time.strftime('%Y%m%d-%H%M%S')}"
        run_dir = write_run_config(Path(args.output_dir) / exp_name, args.method, dp_cfg, cfg.pipeline, args.seed,
                                   args.set)
        pipeline = SplatADPipeline(dp_cfg.setup().get_dataparser_outputs(), cfg.pipeline, device=device)
        state = pipeline.init_state()
    ckpt_dir = run_dir / "checkpoints"
    print(f"[train] {args.method} on {dataparser}: {cfg.trainer.max_num_iterations} iterations from step "
          f"{state.step}, device={device}, run dir {run_dir}")

    metrics: Dict[str, float] = {}
    for i in range(state.step, cfg.trainer.max_num_iterations):
        state, m = pipeline.train_step(state, pipeline.datamanager.next_train())
        if i % cfg.trainer.steps_per_log == 0:
            metrics = {k: float(v) for k, v in m.items()}
            print(f"[train] step {i}: " + ", ".join(f"{k}={v:.5g}" for k, v in metrics.items()), flush=True)
        if i > 0 and i % cfg.trainer.steps_per_save == 0:
            pipeline.save_checkpoint(state, ckpt_dir)
    pipeline.save_checkpoint(state, ckpt_dir)
    print(f"[train] done: {json.dumps(metrics)}")
    return pipeline, state


if __name__ == "__main__":
    entrypoint()
