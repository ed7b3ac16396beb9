"""Train a method on a dataset (torch port of `neurad_tpu/scripts/train.py`):
the ray-based NeuRAD and nerfacto methods, SplatAD and splatfacto, on the
synthetic scene or a logged drive.

    python -m neurad_tpu_torch.scripts.train neurad-tiny --device cpu --max-iterations 40 --output-dir outputs
    python -m neurad_tpu_torch.scripts.train neurad --max-iterations 2000 --output-dir outputs
    python -m neurad_tpu_torch.scripts.train nerfacto-lidar --max-iterations 400
    python -m neurad_tpu_torch.scripts.train splatad --set pipeline.cap_max=200000 --dp-set image_height=480
    python -m neurad_tpu_torch.scripts.train splatad --dataparser kitti --data data/kitti-mot --sequence 0006
    python -m neurad_tpu_torch.scripts.train neurad --load-dir outputs/<run>      # resume
    python -m neurad_tpu_torch.scripts.train splatad --viewer --viewer-port 7007  # live browser viewer

Runs on a CUDA device unless `--device cpu` is given. `--dataparser` names a
parser of `configs/method_configs.DATAPARSERS` (default: the method's);
`--data`, `--sequence` and `--dp-set KEY=VALUE` set its config (a tuple field
takes comma-separated values). A run directory holds `config.json` (method,
dataparser name and settings, the pipeline's configuration) and
`checkpoints/step-<step>.pt` (the newest `trainer.keep_last_n_checkpoints`);
`load_run` rebuilds the pipeline from it. The presets live in
`neurad_tpu_torch/configs/method_configs.py`; methods that other packages
register (`plugins/registry.py`, NEURAD_TPU_TORCH_METHOD_CONFIGS) are found at
start-up. `engine/trainer.Trainer` runs the loop: a NeuRAD or nerfacto run
takes its batches from the datamanager's prefetch threads (`iter_train`), or
from `next_train` when `prefetch` is 0, and its log lines carry the train
rays per second over the steps since the last line; every
`steps_per_eval_batch` steps it scores the eval split
(`pipeline.eval_metrics()`, `eval/<name>`), which a nerfacto run cannot (see
`pipelines/ad_pipeline.py`). `--set trainer.<field>=<value>` sets the
trackers' metric, the early-stopping patience or the checkpoints kept. Log
lines go to the console and, where the `tensorboard` package imports, to
TensorBoard event files in `<run dir>/tb` (otherwise one line says so).
`--viewer` serves the live browser viewer (`viewer/server.py`) on
`--viewer-port` while training: renders, the virtual lidar and an export
into the run directory (a splat PLY of a gaussian model, else a point cloud)
run on the current parameters, under the lock each train step holds. The
JAX script ignores `--viewer` for splatfacto; here every model is served.

Several GPUs train data-parallel (`parallel/sharding.py`), as the JAX script
shards over every device by default: started by torchrun
(`python -m torch.distributed.run --nproc_per_node 8 -m
neurad_tpu_torch.scripts.train neurad ...`; a world over several hosts
needs `--multihost`), the script joins its world, a world of one included; started
plainly on a machine with more than one visible GPU, it spawns one rank per
GPU (nerfstudio's `launch`) unless `--no-mesh` is given. Rank 0 writes the
run directory, checkpoints and log lines and serves the viewer; every rank
evaluates and resumes. The ranks run on `cuda:<LOCAL_RANK>` unless `--device
cpu` is given (gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.configs.method_configs import METHODS, TrainerConfig, dataparser_config, get_method_config
from neurad_tpu_torch.engine.trainer import Trainer
from neurad_tpu_torch.parallel import sharding
from neurad_tpu_torch.pipelines import ad_pipeline, splatad_pipeline, splatfacto_pipeline
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline
from neurad_tpu_torch.pipelines.splatfacto_pipeline import SplatfactoPipeline
from neurad_tpu_torch.plugins.registry import register_discovered_methods
from neurad_tpu_torch.scripts.export import export_gaussian_splat, export_pointcloud
from neurad_tpu_torch.scripts.viewer import viewer_fns
from neurad_tpu_torch.utils.writer import LocalWriter, MultiWriter, TensorboardWriter, Writer
from neurad_tpu_torch.viewer.server import ViewerServer

Pipeline = Union[ADPipeline, SplatADPipeline, SplatfactoPipeline]
TrainState = Union[ad_pipeline.TrainState, splatad_pipeline.TrainState, splatfacto_pipeline.TrainState]


def _parse(value: str, current):
    if isinstance(current, tuple):
        return tuple(_parse(v, current[0]) if current else v for v in value.split(","))
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


def write_run_config(run_dir, method: str, dp_cfg, pipeline_cfg, seed: int, overrides=(),
                     dataparser: str = "synthetic") -> Path:
    """Start a run directory: `config.json` holds what `load_run` needs to
    rebuild the scene (the dataparser's name and config) and the pipeline."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps({
        "method": method, "dataparser": dataparser, "dataparser_config": dataclasses.asdict(dp_cfg),
        "pipeline": pipeline_cfg.to_dict(), "overrides": list(overrides), "seed": seed,
    }, indent=2))
    return run_dir


def load_run(run_dir, device="cuda", with_state: bool = False, mesh: Optional[sharding.Mesh] = None
             ) -> Tuple[Pipeline, Optional[TrainState]]:
    """Rebuild the pipeline of a run directory and load its newest checkpoint
    (and, with `with_state`, the training state to resume from); with a
    `mesh`, as a rank of that data-parallel world."""
    device = resolve_device(device)
    run_dir = Path(run_dir)
    meta = json.loads((run_dir / "config.json").read_text())
    if meta["method"] not in METHODS:
        raise NotImplementedError(f"method {meta['method']!r} is not ported")
    cfg = METHODS[meta["method"]]()
    cfg.pipeline = type(cfg.pipeline).from_dict(meta["pipeline"])
    outputs = dataparser_config(meta["dataparser"], **meta["dataparser_config"]).setup().get_dataparser_outputs()
    pipeline = cfg.build_pipeline(outputs, device=device, mesh=mesh)
    state = pipeline.init_state() if with_state else None
    pipeline.load_checkpoint(run_dir / "checkpoints", state)
    return pipeline, state


def make_writer(run_dir) -> Writer:
    """The console, and TensorBoard event files in `<run_dir>/tb` where the
    `tensorboard` package imports (otherwise one line says so)."""
    writers: List[Writer] = [LocalWriter()]
    try:
        writers.append(TensorboardWriter(str(Path(run_dir) / "tb")))
    except ImportError as e:
        print(f"[train] TensorBoard is not written: the tensorboard package does not import ({e})", flush=True)
    return MultiWriter(writers)


def _start_viewer(pipeline: Pipeline, run_dir: Path, port: int) -> ViewerServer:
    """The live viewer on the pipeline's current parameters, started in the
    background: renders and the virtual lidar as `scripts/viewer.py` serves
    them, and an export into the run directory. The Trainer's steps hold the
    server's lock, as its renders do."""
    render_fn, lidar_fn = viewer_fns(pipeline)

    def export_fn():
        if isinstance(pipeline, (SplatADPipeline, SplatfactoPipeline)):
            path = run_dir / "viewer_export_splat.ply"
            export_gaussian_splat(pipeline.model, path)
        else:
            path = run_dir / "viewer_export_pointcloud.ply"
            export_pointcloud(pipeline, path)
        return str(path)

    server = ViewerServer(render_fn, port=port, lidar_fn=lidar_fn, export_fn=export_fn)
    server.start(background=True)
    return server


def train_loop(pipeline: Pipeline, state: TrainState, trainer: TrainerConfig,
               ckpt_dir: Path) -> Tuple[TrainState, List[Dict[str, float]]]:
    """`Trainer.train` from `state.step` up to `trainer.max_num_iterations`,
    with checkpoints in `ckpt_dir` every `steps_per_save` steps and none at
    the end, log lines on the console. Returns the final state and the
    metrics of every log line and eval."""
    run = Trainer(pipeline, state, dataclasses.replace(trainer, checkpoint_dir=str(ckpt_dir)), writer=LocalWriter())
    run.train(save_at_end=False)
    return run.state, run.history


def _rank_main(local_rank: int, argv: List[str], world_size: int, port: int) -> None:
    """One spawned rank: torchrun's environment for a local world, then the script."""
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    entrypoint(argv)


def spawn_ranks(argv: List[str], world_size: int) -> None:
    """Train with one spawned rank per GPU on this machine; returns when every
    rank has ended (an error in one raises here)."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(list(argv), world_size, sharding.free_port()), nprocs=world_size,
                       start_method="spawn")


def _world(args) -> Optional[sharding.Mesh]:
    """The data-parallel world the script trains in: torchrun's, or none. A
    world whose ranks span several hosts needs `--multihost`, as the JAX
    script joins other hosts only with it (`jax.distributed.initialize()`);
    `--multihost` needs torchrun's environment to join."""
    if not (args.multihost or sharding.in_launched_world()):
        return None
    if not sharding.in_launched_world():
        raise SystemExit("--multihost joins the world that torchrun's environment describes (RANK, WORLD_SIZE, "
                         "MASTER_ADDR, MASTER_PORT); none is set")
    if sharding.spans_hosts() and not args.multihost:
        raise SystemExit(f"torchrun's world of {os.environ['WORLD_SIZE']} ranks spans several hosts "
                         f"({os.environ.get('LOCAL_WORLD_SIZE')} on this one): pass --multihost")
    if args.no_mesh and int(os.environ["WORLD_SIZE"]) > 1:
        raise SystemExit("--no-mesh trains in one process; start the script without a launcher")
    if args.device == "cuda":
        return sharding.make_mesh()  # cuda:<LOCAL_RANK>
    return sharding.make_mesh(device=resolve_device(args.device))


def entrypoint(argv=None, mesh: Optional[sharding.Mesh] = None) -> Optional[Tuple[Pipeline, TrainState]]:
    parser = argparse.ArgumentParser(description="Train a neurad_tpu_torch method")
    parser.add_argument("method", help=f"method name ({', '.join(METHODS)})")
    parser.add_argument("--dataparser", default=None, help="dataparser name (default: the method's)")
    parser.add_argument("--data", default=None, help="dataset root path")
    parser.add_argument("--sequence", default=None, help="sequence id (dataset-specific)")
    parser.add_argument("--max-iterations", type=int, default=None)
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--experiment-name", default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--load-dir", default=None, help="run directory of a previous run to resume from")
    parser.add_argument("--multihost", action="store_true",
                        help="train in a world of torchrun's that spans several hosts (required there; a world "
                             "on this host is joined without it)")
    parser.add_argument("--no-mesh", action="store_true",
                        help="train in one process on one GPU (data-parallel over the visible GPUs by default)")
    parser.add_argument("--viewer", action="store_true", help="serve the live browser viewer during training")
    parser.add_argument("--viewer-port", type=int, default=7007)
    parser.add_argument("--set", action="append", default=[], metavar="PATH=VALUE",
                        help="config override, e.g. trainer.steps_per_log=50 or pipeline.train_ray_chunk=4096")
    parser.add_argument("--dp-set", action="append", default=[], metavar="KEY=VALUE",
                        help="dataparser config override (e.g. image_height=480, cameras=front,back)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if mesh is None:
        mesh = _world(args)
    if mesh is None and not args.no_mesh and args.device == "cuda" and torch.cuda.device_count() > 1:
        spawn_ranks(sys.argv[1:] if argv is None else argv, torch.cuda.device_count())
        return None
    if mesh is not None:
        device = mesh.device
    writes = sharding.is_writer(mesh)
    register_discovered_methods()
    try:
        cfg = get_method_config(args.method)
    except KeyError as e:
        raise SystemExit(e.args[0]) from None
    if args.max_iterations is not None:
        cfg.trainer.max_num_iterations = args.max_iterations
    for ov in args.set:
        path, _, value = ov.partition("=")
        cfg = _with_override(cfg, path, value)
    cfg.pipeline.seed = args.seed
    dataparser = args.dataparser or cfg.dataparser
    dp_cfg = dataparser_config(dataparser)
    for key in ("data", "sequence"):
        if getattr(args, key) is not None:
            if not hasattr(dp_cfg, key):
                raise SystemExit(f"dataparser {dataparser!r} takes no --{key}")
            setattr(dp_cfg, key, getattr(args, key))
    for ov in args.dp_set:
        key, _, value = ov.partition("=")
        if not hasattr(dp_cfg, key):
            raise SystemExit(f"dataparser {dataparser!r} has no setting {key!r}")
        setattr(dp_cfg, key, _parse(value, getattr(dp_cfg, key)))

    if args.load_dir:
        run_dir = Path(args.load_dir)
        pipeline, state = load_run(run_dir, device=device, with_state=True, mesh=mesh)
    else:
        exp_name = args.experiment_name or f"{args.method}-{time.strftime('%Y%m%d-%H%M%S')}"
        if mesh is not None:
            exp_name = sharding.broadcast_object(mesh, exp_name)  # rank 0's clock names the run
        run_dir = Path(args.output_dir) / exp_name
        if writes:
            write_run_config(run_dir, args.method, dp_cfg, cfg.pipeline, args.seed, args.set, dataparser)
        pipeline = cfg.build_pipeline(dp_cfg.setup().get_dataparser_outputs(), device=device, mesh=mesh)
        state = pipeline.init_state()
    cfg.trainer.checkpoint_dir = str(run_dir / "checkpoints")
    world = "" if mesh is None else f", rank {mesh.rank} of {mesh.world_size} ({mesh.backend})"
    print(f"[train] {args.method} on {dataparser}: {cfg.trainer.max_num_iterations} iterations from step "
          f"{state.step}, device={device}{world}, run dir {run_dir}")

    writer = make_writer(run_dir) if writes else None
    trainer = Trainer(pipeline, state, cfg.trainer, writer=writer, mesh=mesh)
    if args.viewer and writes:
        trainer.viewer = _start_viewer(pipeline, run_dir, args.viewer_port)
    try:
        metrics = trainer.train()
    finally:
        if writer is not None:
            writer.close()
        if trainer.viewer is not None:
            trainer.viewer.stop()
    if writes:
        print(f"[train] done: {json.dumps(metrics)}")
    return pipeline, trainer.state


if __name__ == "__main__":
    entrypoint()
