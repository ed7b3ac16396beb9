"""The training loop (torch port of `neurad_tpu/engine/trainer.py`): train
steps, log lines with the train rays per second, periodic evals and
checkpoints, metric trackers that gate saves and stop training early,
callbacks, and a cap on the checkpoints kept.

One loop serves the three pipeline types (`ADPipeline`, `SplatADPipeline`,
`SplatfactoPipeline`): the pipeline owns its train step and checkpoints, and
`train_batches` gives each its batches. A run resumes from a checkpoint that
`load_checkpoint` (or `scripts.train.load_run`) put into the state: the loop
starts at `state.step`. A live viewer (`viewer` set to a
`viewer/server.ViewerServer`) pauses and throttles the loop before each step
and shows its log lines; each step holds the viewer's `train_lock`, which its
renders take too.

In a data-parallel world (`mesh`, `parallel/sharding.py`; the pipeline's own
by default) the loop runs the pipeline's `make_sharded_train_step` on every
rank: the parameters and optimizer state are replicated from rank 0 before
the first step, only rank 0 writes (checkpoints, the writer's lines, the
viewer), every rank evaluates (a NeuRAD render is split over the ranks, and
every rank's trackers see the same values) and every rank loads on resume.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from neurad_tpu_torch.engine.callbacks import TrainingCallback, TrainingCallbackLocation, run_callbacks
from neurad_tpu_torch.parallel import sharding
from neurad_tpu_torch.pipelines.ad_pipeline import CHECKPOINT_PATTERN, ADPipeline
from neurad_tpu_torch.pipelines.splatfacto_pipeline import SplatfactoPipeline
from neurad_tpu_torch.utils.writer import Writer


@dataclasses.dataclass
class MetricTrackerConfig:
    """Which eval metric tells that training degraded."""

    metric: Optional[str] = None  # an eval metric's name; None disables tracking
    higher_is_better: bool = True
    margin: float = 0.1  # tolerance against the best value (0.1 = 10%); < 0 disables


class MetricTracker:
    """Tracks an eval metric: the best value so far and the latest; an eval
    degraded when the latest is worse than the best by more than the
    margin."""

    def __init__(self, config: MetricTrackerConfig):
        self.config = config
        self.best: Optional[float] = None
        self.latest: Optional[float] = None

    def update(self, metrics: Dict[str, float]) -> None:
        self.latest = metrics.get(self.config.metric) if self.config.metric else None
        if self.latest is None:
            return
        if self.best is None or self._is_new_better(self.best, self.latest):
            self.best = self.latest

    def did_degrade(self, fallback: bool = False) -> bool:
        if self.latest is None or self.best is None or self.config.margin < 0:
            return fallback
        sign = -1.0 if self.config.higher_is_better else 1.0
        best = self.best * (1 + sign * self.config.margin)
        return not self._is_new_better(best, self.latest)

    def _is_new_better(self, old: float, new: float) -> bool:
        return new >= old if self.config.higher_is_better else new <= old


@dataclasses.dataclass
class TrainerConfig:
    """Cadences, checkpoints and trackers of a run."""

    max_num_iterations: int = 20001
    steps_per_eval_batch: int = 500  # the loop runs the eval every this many steps
    steps_per_save: int = 2000
    steps_per_log: int = 100
    checkpoint_dir: Optional[str] = None  # None: no checkpoints
    keep_last_n_checkpoints: int = 2  # older ones are deleted after a save (<= 0 keeps all)
    # a degraded eval skips the next periodic save
    save_only_on_improvement_tracker: MetricTrackerConfig = dataclasses.field(default_factory=MetricTrackerConfig)
    # training stops after `early_stop_patience` consecutive degraded evals (0 disables), with a save
    early_stopping_tracker: MetricTrackerConfig = dataclasses.field(default_factory=MetricTrackerConfig)
    early_stop_patience: int = 0


def train_batches(pipeline, mesh: Optional[sharding.Mesh] = None) -> Iterator[Tuple[tuple, Optional[int]]]:
    """The training batches of a pipeline: (`train_step`'s arguments after the
    state, the batch's ray count). A NeuRAD or nerfacto batch comes from the
    datamanager's prefetch threads (`iter_train`), or from `next_train` when
    `prefetch` is 0, and counts its rays (a rank's own); a SplatAD sample is a
    frame or a scan and counts none (in a world, the list of every rank's
    samples, `next_train_batch`, this rank's built); splatfacto draws its
    camera in `train_step`. Closing the iterator stops the threads."""
    if isinstance(pipeline, SplatfactoPipeline):
        while True:
            yield (), None
    dm = pipeline.datamanager
    if not isinstance(pipeline, ADPipeline):
        while True:
            if mesh is not None:
                yield (dm.next_train_batch(mesh.world_size, rank=mesh.rank),), None
            else:
                yield (dm.next_train(),), None
    source = dm.iter_train() if dm.config.prefetch > 0 else iter(dm.next_train, None)
    try:
        for bundle, batch in source:
            yield (bundle, batch), bundle.origins.shape[0]
    finally:
        dm.close()


class Trainer:
    """The loop around a pipeline's `train_step`. `eval_fn` defaults to the
    pipeline's `eval_metrics`; `batches` to `train_batches(pipeline)`
    (closed when the loop ends). `history` holds the metrics of every log
    line and every eval, in order."""

    def __init__(
        self,
        pipeline,
        state,
        config: Optional[TrainerConfig] = None,
        eval_fn: Optional[Callable[[], Dict[str, float]]] = None,
        writer: Optional[Writer] = None,
        callbacks: Sequence[TrainingCallback] = (),
        batches: Optional[Iterator[Tuple[tuple, Optional[int]]]] = None,
        mesh: Optional[sharding.Mesh] = None,
    ):
        self.pipeline = pipeline
        self.mesh = mesh if mesh is not None else getattr(pipeline, "mesh", None)
        self.state = state
        self.config = config or TrainerConfig()
        self.eval_fn = eval_fn if eval_fn is not None else pipeline.eval_metrics
        self.writer = writer
        self.callbacks = list(callbacks)
        self.batches = batches
        self.save_tracker = MetricTracker(self.config.save_only_on_improvement_tracker)
        self.early_tracker = MetricTracker(self.config.early_stopping_tracker)
        self._degraded_evals = 0
        self.history: List[Dict[str, float]] = []
        # a live viewer (`ViewerServer`): its `train_gate` before every step, its stats at every log line
        self.viewer = None

    def _record(self, step: int, metrics: Dict[str, float]) -> None:
        self.history.append(dict(metrics))
        if self.writer is not None and sharding.is_writer(self.mesh):
            self.writer.write_scalars(step, metrics)

    def _sync(self) -> None:
        device = getattr(self.pipeline, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    def train(self, num_iterations: Optional[int] = None, save_at_end: bool = True) -> Dict[str, float]:
        """Steps from `state.step` up to `num_iterations` (default: the
        config's `max_num_iterations`): a log line every `steps_per_log`
        steps and at the last (with `train_rays_per_sec` over the steps since
        the previous line, where the batches count rays), the eval every
        `steps_per_eval_batch` steps (as `eval/<name>`), a checkpoint every
        `steps_per_save` steps unless the last eval degraded, and one at the
        end (`save_at_end`). Returns the last log line's metrics with the
        last eval's, and `early_stopped_at` when the early-stopping tracker
        ended the run. In a data-parallel world the step is the pipeline's
        sharded step and the rays counted are the global batch's."""
        cfg = self.config
        n = cfg.max_num_iterations if num_iterations is None else num_iterations
        mesh = self.mesh
        step_fn = self.pipeline.train_step
        if mesh is not None:
            step_fn = self.pipeline.make_sharded_train_step(mesh)
            sharding.replicate(mesh, self.pipeline.model, self.state.optimizers)
        world = 1 if mesh is None else mesh.world_size
        batches = self.batches if self.batches is not None else train_batches(self.pipeline, mesh)
        last: Dict[str, float] = {}
        rays, t_window = 0, time.perf_counter()
        try:
            for i in range(self.state.step, n):
                if self.viewer is not None:
                    self.viewer.train_gate()
                # The step holds the viewer's lock, and so do its renders: the optimizer writes the parameters in
                # place, and a render must see those of whole steps (the JAX package's renders read one immutable
                # snapshot; nerfstudio's trainer takes the same lock, trainer.py:171).
                with self.viewer.train_lock if self.viewer is not None else contextlib.nullcontext():
                    self.state = run_callbacks(self.callbacks, self.state, i,
                                               TrainingCallbackLocation.BEFORE_TRAIN_ITERATION)
                    args, n_rays = next(batches)
                    self.state, metrics = step_fn(self.state, *args)
                    self.state = run_callbacks(self.callbacks, self.state, i,
                                               TrainingCallbackLocation.AFTER_TRAIN_ITERATION)
                rays += (n_rays or 0) * world
                if i % cfg.steps_per_log == 0 or i == n - 1:
                    last = {k: float(v) for k, v in metrics.items()}
                    if n_rays is not None:
                        self._sync()
                        last["train_rays_per_sec"] = rays / max(time.perf_counter() - t_window, 1e-9)
                    self._record(i, last)
                    if self.viewer is not None:
                        self.viewer.update_train_stats(i, loss=last.get("total_loss"), steps_per_sec=(
                            last["train_rays_per_sec"] / max(n_rays * world, 1) if n_rays is not None else None))
                    rays, t_window = 0, time.perf_counter()
                if self.eval_fn is not None and i > 0 and i % cfg.steps_per_eval_batch == 0:
                    evals = self.eval_fn()
                    self._record(i, {f"eval/{k}": v for k, v in evals.items()})
                    last.update({f"eval/{k}": v for k, v in evals.items()})
                    self.save_tracker.update(evals)
                    self.early_tracker.update(evals)
                    self._degraded_evals = self._degraded_evals + 1 if self.early_tracker.did_degrade() else 0
                    if cfg.early_stop_patience > 0 and self._degraded_evals >= cfg.early_stop_patience:
                        last["early_stopped_at"] = float(i)
                        self.save_checkpoint()
                        return last
                    rays, t_window = 0, time.perf_counter()
                if i > 0 and i % cfg.steps_per_save == 0 and not self.save_tracker.did_degrade(fallback=False):
                    self.save_checkpoint()
        finally:
            if self.batches is None:
                batches.close()
        self.state = run_callbacks(self.callbacks, self.state, n, TrainingCallbackLocation.AFTER_TRAIN)
        if save_at_end:
            self.save_checkpoint()
        return last

    def save_checkpoint(self) -> Optional[Path]:
        """The pipeline's checkpoint of the state in `checkpoint_dir` (none
        without one), then the oldest deleted beyond `keep_last_n_checkpoints`.
        In a data-parallel world every rank calls the pipeline's save, which
        gathers what it needs; rank 0 writes and deletes."""
        if not self.config.checkpoint_dir:
            return None
        path = self.pipeline.save_checkpoint(self.state, self.config.checkpoint_dir)
        keep = self.config.keep_last_n_checkpoints
        if keep > 0 and path is not None:
            for old in sorted(Path(self.config.checkpoint_dir).glob(CHECKPOINT_PATTERN))[:-keep]:
                old.unlink()
        return path

    def load_checkpoint(self, from_dir: Optional[str] = None):
        """Load the newest checkpoint of `from_dir` (default: the run's own
        `checkpoint_dir`) into the pipeline and the state; training then goes
        on from its step and saves into the run's own directory."""
        self.state = self.pipeline.load_checkpoint(from_dir or self.config.checkpoint_dir, self.state)
        return self.state
