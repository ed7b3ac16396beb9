"""Train a method on a dataset (torch port of `neurad_tpu/scripts/train.py`,
on the synthetic scene): the ray-based NeuRAD methods and SplatAD.

    python -m neurad_tpu_torch.scripts.train neurad-tiny --device cpu --max-iterations 40 --output-dir outputs
    python -m neurad_tpu_torch.scripts.train neurad --max-iterations 2000 --output-dir outputs
    python -m neurad_tpu_torch.scripts.train splatad --set pipeline.cap_max=200000 --dp-set image_height=480
    python -m neurad_tpu_torch.scripts.train neurad --load-dir outputs/<run>      # resume

Runs on a CUDA device unless `--device cpu` is given. A run directory holds
`config.json` (method, dataparser settings, the pipeline's configuration) and
`checkpoints/step-<step>.pt`; `load_run` rebuilds either pipeline from it. The
presets live in `neurad_tpu_torch/configs/method_configs.py`. A NeuRAD run
takes its batches from the datamanager's prefetch threads (`iter_train`), or
from `next_train` when `prefetch` is 0; its log lines carry the train rays
per second over the steps since the last line. Every `steps_per_eval_batch`
steps the loop scores the eval split (`pipeline.eval_metrics()`) and logs
the results as `eval/<name>`. The viewer and TensorBoard are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.configs.method_configs import METHODS, TrainerConfig
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neurad_tpu_torch.pipelines import ad_pipeline, splatad_pipeline
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig

Pipeline = Union[ADPipeline, SplatADPipeline]
TrainState = Union[ad_pipeline.TrainState, splatad_pipeline.TrainState]


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


def write_run_config(run_dir, method: str, dp_cfg: SyntheticDataParserConfig,
                     pipeline_cfg: Union[ADPipelineConfig, SplatADPipelineConfig], seed: int, overrides=()) -> Path:
    """Start a run directory: `config.json` holds what `load_run` needs to
    rebuild the scene and the pipeline."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps({
        "method": method, "dataparser": "synthetic", "dataparser_config": dataclasses.asdict(dp_cfg),
        "pipeline": pipeline_cfg.to_dict(), "overrides": list(overrides), "seed": seed,
    }, indent=2))
    return run_dir


def _pipeline_classes(method: str):
    """(pipeline class, its config class) of a method."""
    if METHODS[method]().pipeline_type == "ad":
        return ADPipeline, ADPipelineConfig
    return SplatADPipeline, SplatADPipelineConfig


def load_run(run_dir, device="cuda", with_state: bool = False) -> Tuple[Pipeline, Optional[TrainState]]:
    """Rebuild the pipeline of a run directory and load its newest checkpoint
    (and, with `with_state`, the training state to resume from)."""
    device = resolve_device(device)
    run_dir = Path(run_dir)
    meta = json.loads((run_dir / "config.json").read_text())
    if meta["dataparser"] != "synthetic":
        raise NotImplementedError(f"dataparser {meta['dataparser']!r} is not ported")
    if meta["method"] not in METHODS:
        raise NotImplementedError(f"method {meta['method']!r} is not ported")
    pipeline_cls, cfg_cls = _pipeline_classes(meta["method"])
    outputs = SyntheticDataParserConfig(**meta["dataparser_config"]).setup().get_dataparser_outputs()
    pipeline = pipeline_cls(outputs, cfg_cls.from_dict(meta["pipeline"]), device=device)
    state = pipeline.init_state() if with_state else None
    pipeline.load_checkpoint(run_dir / "checkpoints", state)
    return pipeline, state


def _log_step(i: int, metrics: Dict[str, torch.Tensor], extra: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    out = {k: float(v) for k, v in metrics.items()}
    out.update(extra or {})
    print(f"[train] step {i}: " + ", ".join(f"{k}={v:.5g}" for k, v in out.items()), flush=True)
    return out


def train_batches(pipeline: Pipeline) -> Iterator[Tuple[tuple, Optional[int]]]:
    """The training batches of a pipeline: (`train_step`'s arguments after the
    state, the batch's ray count). A NeuRAD batch comes from the
    datamanager's prefetch threads (`iter_train`), or from `next_train` when
    `prefetch` is 0, and counts its rays; a SplatAD sample is a frame or a
    scan and counts none. Closing the iterator stops the threads."""
    dm = pipeline.datamanager
    if not isinstance(pipeline, ADPipeline):
        while True:
            yield (dm.next_train(),), None
    source = dm.iter_train() if dm.config.prefetch > 0 else iter(dm.next_train, None)
    try:
        for bundle, batch in source:
            yield (bundle, batch), bundle.origins.shape[0]
    finally:
        dm.close()


def train_loop(pipeline: Pipeline, state: TrainState, trainer: TrainerConfig,
               ckpt_dir: Path) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Steps from `state.step` up to `trainer.max_num_iterations`: one
    `train_step` a batch, a log line every `steps_per_log` steps and at the
    last (with the train rays per second since the previous line, where the
    batches count rays), the eval metrics every `steps_per_eval_batch` steps
    (a line of their own, `eval/<name>`), a checkpoint every
    `steps_per_save`. Returns the final state and the metrics of every log
    line and eval."""
    batches = train_batches(pipeline)
    history: List[Dict[str, float]] = []
    rays, t_window = 0, time.perf_counter()
    try:
        for i in range(state.step, trainer.max_num_iterations):
            args, n_rays = next(batches)
            state, m = pipeline.train_step(state, *args)
            rays += n_rays or 0
            if i % trainer.steps_per_log == 0 or i == trainer.max_num_iterations - 1:
                extra = {}
                if n_rays is not None:
                    if pipeline.device.type == "cuda":
                        torch.cuda.synchronize(pipeline.device)
                    extra["train_rays_per_sec"] = rays / max(time.perf_counter() - t_window, 1e-9)
                history.append(_log_step(i, m, extra))
                rays, t_window = 0, time.perf_counter()
            if i > 0 and i % trainer.steps_per_eval_batch == 0:
                history.append(_log_step(i, {f"eval/{k}": v for k, v in pipeline.eval_metrics().items()}))
                rays, t_window = 0, time.perf_counter()
            if i > 0 and i % trainer.steps_per_save == 0:
                pipeline.save_checkpoint(state, ckpt_dir)
    finally:
        batches.close()
    return state, history


def entrypoint(argv=None) -> Tuple[Pipeline, TrainState]:
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
                        help="config override, e.g. trainer.steps_per_log=50 or pipeline.train_ray_chunk=4096")
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
        pipeline_cls, _ = _pipeline_classes(args.method)
        pipeline = pipeline_cls(dp_cfg.setup().get_dataparser_outputs(), cfg.pipeline, device=device)
        state = pipeline.init_state()
    ckpt_dir = run_dir / "checkpoints"
    print(f"[train] {args.method} on {dataparser}: {cfg.trainer.max_num_iterations} iterations from step "
          f"{state.step}, device={device}, run dir {run_dir}")

    state, history = train_loop(pipeline, state, cfg.trainer, ckpt_dir)
    pipeline.save_checkpoint(state, ckpt_dir)
    print(f"[train] done: {json.dumps(history[-1] if history else {})}")
    return pipeline, state


if __name__ == "__main__":
    entrypoint()
