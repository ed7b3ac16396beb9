"""SplatAD pipeline (torch port of `neurad_tpu/pipelines/splatad_pipeline.py`):
scene seeding, the model, full-sensor training with densification, checkpoints,
and the eval/viewer renders.

The pipeline owns its model, and the model owns the parameters (the JAX
pipeline carries them in a TrainState). `init_state` makes the rest of the
training state: the per-group optimizers, the step count and the generator the
densification draws from, at step 0 or at a step of the schedules. `train_step`
takes one camera frame or one lidar scan: forward, loss, backward (the tile
composites' backward kernels on a CUDA device), one optimizer update, then the
densification strategy when it is due (spans `train.forward`,
`train.backward`, `train.optimizer`, `train.refine`).
`eval_metrics` and `eval_fid_suite` score the eval split.
`make_sharded_train_step` is the data-parallel step over a `torch.distributed`
world (one frame or scan a rank, `parallel/sharding.py`);
`_make_camera_step_batched` and `_make_lidar_step_batched` are the same update
in one process.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs
from neurad_tpu_torch.data.full_image_datamanager import (
    CameraSample,
    FullImageLidarDataManager,
    FullImageLidarDataManagerConfig,
    LidarSample,
)
from neurad_tpu_torch.engine.optimizers import OptimizerGroupConfig, Optimizers
from neurad_tpu_torch.model_components import losses as L
from neurad_tpu_torch.model_components.dynamic_actors import (
    ActorEdits,
    actor_data_from_trajectories,
    empty_actor_data,
)
from neurad_tpu_torch.model_components.strategy import (
    DefaultStrategyConfig,
    MCMCStrategyConfig,
    default_refine,
    mcmc_add_noise,
    mcmc_relocate,
    reset_opacities,
    should_refine,
    should_refine_default,
)
from neurad_tpu_torch.models.splatad import SplatADConfig, SplatADModel, seed_gaussians
from neurad_tpu_torch.parallel import sharding
from neurad_tpu_torch.utils import profiler
from neurad_tpu_torch.utils.eval_metrics import fid, fid_suite_shifts

# Per-group learning-rate presets, grouped by parameter name.
SPLATAD_OPTIMIZER_GROUPS = {
    "means": OptimizerGroupConfig(lr=1.6e-4, lr_final=1.6e-6, max_steps=30000),
    "features": OptimizerGroupConfig(lr=2.5e-3),
    "opacities": OptimizerGroupConfig(lr=5e-2),
    "scales": OptimizerGroupConfig(lr=5e-3),
    "quats": OptimizerGroupConfig(lr=1e-3),
    "fields": OptimizerGroupConfig(lr=1e-3, weight_decay=1e-6),  # decoders / embeddings
    "trajectory_opt": OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, warmup_steps=2500),
    "camera_opt": OptimizerGroupConfig(lr=1e-4, lr_final=1e-5, warmup_steps=2500),
}

SPLATAD_GROUP_RULES = (
    ("means", "means"),
    ("features", "features"),
    ("opacities", "opacities"),
    ("scales", "scales"),
    ("quats", "quats"),
    ("actor_positions", "trajectory_opt"),
    ("actor_rotations_6d", "trajectory_opt"),
    ("actor_vel_", "trajectory_opt"),
    ("pose_adjustment", "camera_opt"),
    ("velocity_adjustment", "camera_opt"),
    ("time_to_center_pixel_adjustment", "camera_opt"),
)

GAUSSIAN_KEYS = ("means", "scales", "quats", "opacities", "features")
CHECKPOINT_PATTERN = "step-*.pt"


@dataclasses.dataclass
class SplatADPipelineConfig:
    datamanager: FullImageLidarDataManagerConfig = dataclasses.field(
        default_factory=FullImageLidarDataManagerConfig
    )
    model: SplatADConfig = SplatADConfig()
    # densification: "mcmc" (fixed-capacity relocation) or "default" (absgrad
    # grow / split / prune)
    strategy: str = "mcmc"
    mcmc: MCMCStrategyConfig = MCMCStrategyConfig()
    default_strategy: DefaultStrategyConfig = DefaultStrategyConfig()
    cap_max: int = 500_000
    optimizer_groups: dict = dataclasses.field(default_factory=lambda: dict(SPLATAD_OPTIMIZER_GROUPS))
    seed: int = 0

    def to_dict(self) -> dict:
        """Plain nested dict (json-serialisable), the inverse of `from_dict`."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SplatADPipelineConfig":
        model = dict(d["model"])
        model["lidar_elev_range"] = tuple(model["lidar_elev_range"])
        return cls(
            datamanager=FullImageLidarDataManagerConfig(**d["datamanager"]),
            model=SplatADConfig(**model),
            strategy=d["strategy"],
            mcmc=MCMCStrategyConfig(**d["mcmc"]),
            default_strategy=DefaultStrategyConfig(**d["default_strategy"]),
            cap_max=d["cap_max"],
            optimizer_groups={k: OptimizerGroupConfig(**v) for k, v in d["optimizer_groups"].items()},
            seed=d["seed"],
        )


@dataclasses.dataclass
class TrainState:
    """What training carries besides the model's parameters."""

    step: int
    optimizers: Optimizers
    generator: torch.Generator  # the densification strategies' draws


class SplatADPipeline:
    def __init__(
        self,
        outputs: ADDataparserOutputs,
        config: Optional[SplatADPipelineConfig] = None,
        device="cuda",
        mesh: Optional[sharding.Mesh] = None,
    ):
        self.device = resolve_device(device)
        self.config = config or SplatADPipelineConfig()
        self.outputs = outputs
        # the data-parallel world (None: one process); every rank draws the same samples, and rank 0 writes
        self.mesh = mesh
        self.datamanager = FullImageLidarDataManager(outputs, self.config.datamanager, seed=self.config.seed)

        seed_pts = self.datamanager.all_seed_points()
        actor_data = (
            actor_data_from_trajectories(outputs.trajectories) if outputs.trajectories else empty_actor_data()
        )
        init = seed_gaussians(
            seed_pts,
            outputs.trajectories,
            cap_max=self.config.cap_max,
            feature_dim=self.config.model.feature_dim,
            scene_aabb=outputs.scene_box.aabb.numpy(),
            seed=self.config.seed,
        )
        self.model = SplatADModel(
            init_data=init,
            actor_data=actor_data,
            config=self.config.model,
            num_sensors=len(outputs.sensor_idx_to_name),
            num_train_images=len(outputs.images),
            generator=torch.Generator().manual_seed(self.config.seed),
        ).to(self.device)
        self.model.eval()
        # absgrad running sums (Default strategy; camera steps only)
        self._grad2d_sum: Optional[torch.Tensor] = None
        self._count: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None, step: int = 0) -> TrainState:
        """A fresh training state. `step` > 0 starts the schedules there: the
        step count, which the resolution and densification schedules read,
        and every group's learning-rate schedule (`Optimizers.start_at`),
        with Adam's moments at zero, as a run that loads a model's
        parameters at that step and starts its optimizers afresh."""
        if self.config.strategy not in ("mcmc", "default"):
            raise ValueError(f"unknown densification strategy {self.config.strategy!r}")
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.config.seed if seed is None else seed)
        optimizers = Optimizers(self.model.named_parameters(), self.config.optimizer_groups, SPLATAD_GROUP_RULES)
        optimizers.start_at(step)
        return TrainState(step=step, optimizers=optimizers, generator=generator)

    def _downscale_sample(self, sample: CameraSample, step: int) -> CameraSample:
        """Coarse to fine: the image is subsampled by
        2^max(0, num_downscales - step // resolution_schedule)."""
        cfg = self.config.model
        if cfg.num_downscales <= 0 or cfg.resolution_schedule <= 0:
            return sample
        d = 2 ** max(0, cfg.num_downscales - step // cfg.resolution_schedule)
        if d <= 1:
            return sample
        img = sample.image[::d, ::d]
        K = sample.K.copy()
        K[:2] /= d
        return dataclasses.replace(sample, image=img, K=K, width=img.shape[1], height=img.shape[0])

    def _offset(self, sample) -> Optional[torch.Tensor]:
        """The zeros `means2d_offset` whose gradient is the absgrad signal
        (Default strategy, camera samples), else None."""
        if self.config.strategy != "default" or not isinstance(sample, CameraSample):
            return None
        return torch.zeros((self.model.means.shape[0], 2), device=self.device, requires_grad=True)

    def _forward_loss(self, sample, offset: Optional[torch.Tensor] = None):
        """(loss, metrics, outputs) of one camera frame or lidar scan."""
        model = self.model
        if isinstance(sample, CameraSample):
            out = model.get_camera_outputs(
                sample.c2w, sample.K, sample.width, sample.height, sample.time, sample.sensor_idx, sample.cam_idx,
                cam_linear_vel=sample.linear_velocity,
                rolling_shutter_time=sample.rolling_shutter_time,
                time_to_center_pixel=sample.time_to_center_pixel,
                means2d_offset=offset,
            )
            total, metrics = model.camera_loss(out, sample.image)
        elif isinstance(sample, LidarSample):
            out = model.get_lidar_outputs(
                sample.l2w, sample.raster_pts, sample.time, sample.sensor_idx,
                lidar_linear_vel=sample.linear_velocity,
            )
            total, metrics = model.lidar_loss(out, sample.raster_pts, sample.did_return, sample.valid)
        else:
            raise TypeError(f"train_step takes a CameraSample or a LidarSample, got {type(sample).__name__}")
        return total, metrics, out

    @staticmethod
    def _absgrad(offset_grad: torch.Tensor, out: Dict[str, torch.Tensor], sample: CameraSample, scale: float = 1.0):
        """(pixel-gradient norms where the gaussian was visible, visibility as
        int32): the gradients scaled by half the image dimensions, as gsplat
        does, and by `scale` (a batched step's n undoes its mean's 1/n)."""
        g2d = torch.linalg.norm(offset_grad * offset_grad.new_tensor(
            [scale * sample.width / 2.0, scale * sample.height / 2.0]), dim=-1)
        visible = out["radii"] > 0
        return torch.where(visible, g2d, torch.zeros_like(g2d)), visible.to(torch.int32)

    def _accumulate_absgrad(self, g2d: torch.Tensor, count: torch.Tensor) -> None:
        if self._grad2d_sum is None:
            self._grad2d_sum = torch.zeros_like(g2d)
            self._count = torch.zeros_like(count)
        self._grad2d_sum += g2d
        self._count += count

    def train_step(self, state: TrainState, sample) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer update from a camera frame or a lidar scan, then the
        densification strategy when it is due. Metrics are detached tensors on
        the model's device."""
        model = self.model
        if isinstance(sample, CameraSample):
            sample = self._downscale_sample(sample, state.step)
        offset = self._offset(sample)
        model.train()
        try:
            with profiler.span("train.forward"):
                total, metrics, out = self._forward_loss(sample, offset)
            with profiler.span("train.backward"):
                state.optimizers.zero_grad()
                total.backward()
            with profiler.span("train.optimizer"):
                state.optimizers.step()
        finally:
            model.eval()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        if offset is not None:
            self._accumulate_absgrad(*self._absgrad(offset.grad, out, sample))
        self._maybe_refine(state)
        return state, metrics

    # ------------------------------------------------------------------
    # data-parallel training: one camera frame or lidar scan per rank, the
    # per-sample losses averaged (nerfstudio's DDP semantics). The batched
    # steps are the same update in one process.
    # ------------------------------------------------------------------

    def _step_batched(self, state: TrainState, samples) -> Tuple[TrainState, Dict, tuple]:
        """One update from n same-modality samples: the mean of their losses
        (each sample's backward taken in turn, scaled by 1/n), and the absgrad
        statistics summed over the samples with the mean's 1/n undone. No
        refine. Returns (state, metrics averaged over the samples, (absgrad
        sums, visibility counts))."""
        model = self.model
        n = len(samples)
        if isinstance(samples[0], CameraSample):
            samples = [self._downscale_sample(s, state.step) for s in samples]
        n_gauss = model.means.shape[0]
        g2d_sum = torch.zeros(n_gauss, device=self.device)
        count = torch.zeros(n_gauss, dtype=torch.int32, device=self.device)
        totals, per_sample = [], []
        model.train()
        try:
            state.optimizers.zero_grad()
            for s in samples:
                offset = self._offset(s)
                total, metrics, out = self._forward_loss(s, offset)
                (total / n).backward()
                totals.append(total.detach())
                per_sample.append({k: v.detach() for k, v in metrics.items()})
                if offset is not None:
                    g2d, vis = self._absgrad(offset.grad, out, s, scale=float(n))
                    g2d_sum += g2d
                    count += vis
            state.optimizers.step()
        finally:
            model.eval()
        state.step += 1
        metrics = {k: torch.stack([m[k] for m in per_sample]).float().mean() for k in per_sample[0]}
        metrics["total_loss"] = torch.stack(totals).mean()
        return state, metrics, (g2d_sum, count)

    def _make_camera_step_batched(self):
        """The batched camera step: step(state, samples) -> (state, metrics, (absgrad sums, counts))."""
        return self._step_batched

    def _make_lidar_step_batched(self):
        """The batched lidar step: step(state, samples) -> (state, metrics)."""
        return lambda state, samples: self._step_batched(state, samples)[:2]

    def make_sharded_train_step(self, mesh: Optional[sharding.Mesh] = None):
        """train_step_sharded(state, samples) over `mesh` (default: the
        pipeline's): `samples` is one list of `world_size` same-modality
        samples that every rank draws alike (`next_train_batch`); rank r
        trains on samples[r]. The gradients are averaged over the ranks, the
        absgrad sums and visibility counts summed over them before the
        strategy runs, and every rank refines with the same generator. A rank
        whose sample is of another modality raises."""
        mesh = mesh or self.mesh
        if mesh is None:
            raise ValueError("make_sharded_train_step needs a mesh")
        model = self.model

        def run(state: TrainState, samples) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            if len(samples) != mesh.world_size:
                raise ValueError(f"{len(samples)} samples for a world of {mesh.world_size}")
            sample = samples[mesh.rank]
            is_camera = isinstance(sample, CameraSample)
            sharding.same_on_every_rank(mesh, float(is_camera), "the step's modality")
            if is_camera:
                sample = self._downscale_sample(sample, state.step)
            offset = self._offset(sample)
            model.train()
            try:
                total, metrics, out = self._forward_loss(sample, offset)
                state.optimizers.zero_grad()
                total.backward()
                sharding.all_reduce_gradients(mesh, sharding.optimizer_params(state.optimizers))
                state.optimizers.step()
            finally:
                model.eval()
            state.step += 1
            metrics = sharding.reduce_metrics(mesh, {**{k: v.detach() for k, v in metrics.items()},
                                                     "total_loss": total.detach()})
            if offset is not None:
                g2d, count = self._absgrad(offset.grad, out, sample)
                self._accumulate_absgrad(sharding.all_reduce_(mesh, g2d), sharding.all_reduce_(mesh, count))
            self._maybe_refine(state)
            return state, metrics

        return run

    def _gaussians(self) -> Dict[str, torch.Tensor]:
        gauss = {k: getattr(self.model, k).detach() for k in GAUSSIAN_KEYS}
        gauss["id"] = self.model.gauss_ids
        return gauss

    @torch.no_grad()
    def _set_gaussians(self, gauss: Dict[str, torch.Tensor]) -> None:
        for k in GAUSSIAN_KEYS:
            getattr(self.model, k).copy_(gauss[k])

    def _actor_bounds(self) -> Optional[torch.Tensor]:
        if not self.model.n_actors:
            return None
        sizes = torch.as_tensor(self.model.actor_data.sizes, dtype=torch.float32, device=self.device)
        return sizes / 2.0 + sizes.new_tensor((0.25, 0.25, 0.1))

    def _maybe_refine(self, state: TrainState) -> None:
        """Densify / prune / reset after a step, when the strategy says so."""
        step = state.step
        if self.config.strategy == "default":
            cfg = self.config.default_strategy
            if should_refine_default(step, cfg):
                with profiler.span("train.refine"):
                    self._refine_default(state)
            if step % cfg.reset_every == 0 and 0 < step < cfg.refine_stop_iter:
                with profiler.span("train.refine"):
                    self._set_gaussians(reset_opacities(self._gaussians(), cfg))
        elif should_refine(step, self.config.mcmc):
            with profiler.span("train.refine"):
                self._refine(state)

    def _refine(self, state: TrainState, targets=None, eps=None) -> None:
        """MCMC relocation + exploration noise. As in the JAX pipeline the
        optimizer's moments are left as they are. targets / eps: explicit draws
        (see `mcmc_relocate`, `mcmc_add_noise`)."""
        new_gauss, _ = mcmc_relocate(
            state.generator, self._gaussians(), None, self.config.mcmc, self._actor_bounds(), self.model.n_actors,
            targets=targets,
        )
        lr_means = self.config.optimizer_groups["means"].schedule()(state.step)
        self._set_gaussians(mcmc_add_noise(state.generator, new_gauss, lr_means, self.config.mcmc, eps=eps))

    def _refine_default(self, state: TrainState, keep_u=None, split_eps=None) -> None:
        """absgrad grow / split / prune with actor-aware culling, from the
        running mean of the screen-space gradient norms; the sums start anew."""
        if self._grad2d_sum is None:
            raise RuntimeError("the Default strategy refines after at least one camera step")
        scene_scale = float(self.outputs.scene_box.aabb.abs().max())
        grad_avg = self._grad2d_sum / self._count.to(torch.float32).clamp_min(1.0)
        new_gauss, _ = default_refine(
            state.generator, self._gaussians(), grad_avg, self.config.default_strategy, scene_scale, step=state.step,
            actor_bounds=self._actor_bounds(), n_actors=self.model.n_actors, keep_u=keep_u, split_eps=split_eps,
        )
        self._set_gaussians(new_gauss)
        self._grad2d_sum.zero_()
        self._count.zero_()

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, state: TrainState, checkpoint_dir) -> Path:
        """Write `step-<step>.pt`: the model's state dict, the optimizers'
        state, the step, the generator's and the datamanager sampler's state
        and the absgrad sums. In a data-parallel world rank 0 writes (the
        others return None) and every rank waits for the file."""
        if not sharding.is_writer(self.mesh):
            sharding.barrier(self.mesh)
            return None
        checkpoint_dir = Path(checkpoint_dir)
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
        path = checkpoint_dir / f"step-{state.step:09d}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(
            {
                "step": state.step,
                "model": self.model.state_dict(),
                "optimizers": state.optimizers.state_dict(),
                "generator": state.generator.get_state(),
                "datamanager_rng": self.datamanager.rng_state(),
                "grad2d_sum": self._grad2d_sum,
                "count": self._count,
            },
            tmp,
        )
        tmp.replace(path)
        if self.mesh is not None:
            sharding.barrier(self.mesh)
        return path

    @staticmethod
    def latest_checkpoint(checkpoint_dir) -> Path:
        found = sorted(Path(checkpoint_dir).glob(CHECKPOINT_PATTERN))
        if not found:
            raise FileNotFoundError(f"no checkpoint ({CHECKPOINT_PATTERN}) in {checkpoint_dir}")
        return found[-1]

    def load_checkpoint(self, checkpoint_dir, state: Optional[TrainState] = None) -> Optional[TrainState]:
        """Load the newest checkpoint of `checkpoint_dir` into the model and,
        when a training state is given, into it and the datamanager's sampler."""
        ckpt = torch.load(self.latest_checkpoint(checkpoint_dir), map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        if state is None:
            return None
        state.step = int(ckpt["step"])
        state.optimizers.load_state_dict(ckpt["optimizers"])
        state.generator.set_state(ckpt["generator"].cpu())
        self.datamanager.set_rng_state(ckpt["datamanager_rng"])
        self._grad2d_sum, self._count = ckpt["grad2d_sum"], ckpt["count"]
        return state

    # ------------------------------------------------------------------
    # renders
    # ------------------------------------------------------------------

    def _render_camera(self, cam_idx: int, edits: Optional[ActorEdits] = None) -> torch.Tensor:
        """An eval camera's full-image render, with its velocity and rolling
        shutter -> rgb [H, W, 3] on the pipeline's device."""
        with profiler.span("pipeline.rays"):
            s = self.datamanager._camera_sample(cam_idx)
        out = self.model.get_camera_outputs(
            s.c2w, s.K, s.width, s.height, s.time, s.sensor_idx, s.cam_idx,
            cam_linear_vel=s.linear_velocity,
            rolling_shutter_time=s.rolling_shutter_time,
            time_to_center_pixel=s.time_to_center_pixel,
            edits=edits,
        )
        return out["rgb"]

    @torch.inference_mode()
    def render_eval_camera(self, cam_idx: int, edits: Optional[ActorEdits] = None):
        """Full-image render -> (pred rgb [H, W, 3], gt rgb), numpy."""
        rgb = self._render_camera(cam_idx, edits)
        with profiler.span("pipeline.to_host"):
            rgb = rgb.cpu().numpy()
        with profiler.span("pipeline.rays"):
            return rgb, self.datamanager._camera_sample(cam_idx).image

    @torch.inference_mode()
    def render_eval_lidar(self, scan_idx: int) -> Dict[str, np.ndarray]:
        """Lidar scan render with the ray pipeline's output keys
        (depth/intensity/ray_drop_logits/gt_*/origins/directions)."""
        s = self.datamanager._lidar_sample(scan_idx)
        out = self.model.get_lidar_outputs(
            s.l2w, s.raster_pts, s.time, s.sensor_idx, lidar_linear_vel=s.linear_velocity
        )
        azim = np.deg2rad(s.raster_pts[:, 0])
        elev = np.deg2rad(s.raster_pts[:, 1])
        dirs_l = np.stack([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)], axis=-1)
        l2w = np.asarray(s.l2w)
        dirs = dirs_l @ l2w[:3, :3].T
        return {
            "depth": out["depth"].cpu().numpy(),
            "intensity": out["intensity"].cpu().numpy(),
            "ray_drop_logits": out["ray_drop_logits"].cpu().numpy(),
            "gt_distance": s.raster_pts[:, 2:3],
            "gt_intensity": s.raster_pts[:, 4:5],
            "did_return": np.asarray(s.did_return & s.valid)[:, None],
            "origins": np.broadcast_to(l2w[:3, 3], dirs.shape),
            "directions": dirs,
        }

    @torch.inference_mode()
    def render_viewer_image(
        self, c2w: np.ndarray, width: int, height: int, time: float, edits_vec=None
    ) -> np.ndarray:
        """Viewer render at an arbitrary pose: focal 0.7*width, sensor 0, and
        `edits_vec` = (lateral, longitudinal, rotation, height, rolling-shutter
        time), missing entries zero."""
        ev = np.zeros(5, np.float32)
        if edits_vec is not None:
            vals = np.asarray(edits_vec, np.float32)[:5]
            ev[: len(vals)] = vals
        focal = 0.7 * width
        K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]], np.float32)
        edits = ActorEdits(lateral=float(ev[0]), longitudinal=float(ev[1]), rotation=float(ev[2]), height=float(ev[3]))
        out = self.model.get_camera_outputs(
            np.asarray(c2w, np.float32)[:3], K, width, height, float(time), 0, 0,
            rolling_shutter_time=float(ev[4]),
            edits=edits,
        )
        return out["rgb"].cpu().numpy()

    @torch.inference_mode()
    def render_virtual_lidar(
        self, origin: np.ndarray, time: float, channels: int = 32, azim_res_deg: float = 1.0, fov_up: float = 5.0,
        fov_down: float = -15.0, drop_threshold: float = 0.5, edits_vec=None,
    ) -> np.ndarray:
        """Virtual-lidar point cloud for the viewer: a spherical scan of
        `channels` x 360 / `azim_res_deg` beams at `origin` (axes of the
        world), rendered through the spherical rasterizer; points whose
        predicted ray-drop probability is below the threshold are kept -> [N,
        4] (world xyz + intensity). `edits_vec` = (lateral, longitudinal,
        rotation, height) of every actor."""
        elev = np.linspace(fov_down, fov_up, channels)
        azim = np.arange(-180.0, 180.0, azim_res_deg)
        el, azm = np.meshgrid(elev, azim, indexing="ij")
        zeros = np.zeros(el.size)
        pts = np.stack([azm.reshape(-1), el.reshape(-1), zeros, zeros, zeros], axis=-1).astype(np.float32)
        ev = [0.0] * 4 if edits_vec is None else [float(v) for v in np.asarray(edits_vec, np.float32)[:4]]
        edits = ActorEdits(lateral=ev[0], longitudinal=ev[1], rotation=ev[2], height=ev[3], index=-1)
        l2w = np.eye(4, dtype=np.float32)[:3]
        l2w[:, 3] = np.asarray(origin, np.float32)
        out = self.model.get_lidar_outputs(l2w, pts, float(time), 0, edits=edits)
        depth, intensity = out["depth"].cpu().numpy(), out["intensity"].cpu().numpy()
        keep = 1.0 / (1.0 + np.exp(-out["ray_drop_logits"].cpu().numpy()[:, 0])) < drop_threshold
        azim_r, elev_r = np.deg2rad(pts[:, 0]), np.deg2rad(pts[:, 1])
        dirs = np.stack([np.cos(elev_r) * np.cos(azim_r), np.cos(elev_r) * np.sin(azim_r), np.sin(elev_r)], axis=-1)
        world = np.asarray(origin)[None] + dirs * depth
        return np.concatenate([world, intensity], axis=-1)[keep]

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _render_eval_rgb(self, cam_idx: int, c2w=None) -> torch.Tensor:
        """An eval camera's render as the metrics take it: the frame's pose
        (or `c2w`), intrinsics, time and sensor, without velocity or rolling
        shutter -> rgb [H, W, 3] on the device."""
        s = self.datamanager._camera_sample(cam_idx)
        out = self.model.get_camera_outputs(s.c2w if c2w is None else c2w, s.K, s.width, s.height, s.time,
                                            s.sensor_idx, s.cam_idx)
        return out["rgb"]

    @torch.inference_mode()
    def eval_metrics(self) -> Dict[str, float]:
        """PSNR and SSIM over the eval cameras (on the device), and the depth
        errors over the eval scans' valid returns: the mean over scans of the
        median squared error (host numpy) and of the mean squared error
        relative to the squared distance."""
        metrics: Dict[str, float] = {}
        cams = self.outputs.eval_camera_indices
        if cams:
            psnrs, ssims = [], []
            for ci in cams:
                rgb = self._render_eval_rgb(ci)
                gt = torch.as_tensor(self.datamanager._camera_sample(ci).image, device=self.device)
                psnrs.append(float(L.psnr(rgb, gt)))
                ssims.append(float(L.ssim(rgb, gt)))
            metrics["psnr"] = float(np.mean(psnrs))
            metrics["ssim"] = float(np.mean(ssims))
        scans = self.outputs.eval_lidar_indices
        if scans:
            med, rel = [], []
            for si in scans:
                s = self.datamanager._lidar_sample(si)
                out = self.model.get_lidar_outputs(s.l2w, s.raster_pts, s.time, s.sensor_idx)
                ret = torch.as_tensor(np.asarray(s.valid & s.did_return), device=self.device)
                dist = torch.as_tensor(s.raster_pts[:, 2], device=self.device)[ret]
                err2 = (out["depth"][:, 0][ret] - dist) ** 2
                med.append(float(np.median(err2.cpu().numpy())))
                rel.append(float(torch.mean(err2 / (dist**2).clamp_min(1e-6))))
            metrics["depth_median_l2"] = float(np.mean(med))
            metrics["depth_mean_rel_l2"] = float(np.mean(rel))
        return metrics

    @torch.inference_mode()
    def eval_fid_suite(self, max_images: Optional[int] = None) -> Dict[str, float]:
        """Novel-view FID of the first `max_images` eval cameras (all by
        default) against their images: actor edits (rotation +-0.5 rad,
        lateral +-2 m, both signs pooled) where the scene has actors, lane
        shifts of 2 and 3 m (signed by the sequence's `lane_shift_sign`) and a
        vertical shift of 1 m, each by moving the camera pose."""
        lane_sign = 1
        if self.outputs.metadata and "lane_shift_sign" in self.outputs.metadata:
            lane_sign = int(self.outputs.metadata["lane_shift_sign"])
        cams = list(self.outputs.eval_camera_indices)
        if max_images is not None:
            cams = cams[:max_images]
        if not cams:
            return {}
        real = [self.datamanager._camera_sample(ci).image for ci in cams]
        metrics: Dict[str, float] = {}
        if self.model.actor_data.n_actors > 0:
            actor_edits = {
                "rot": (ActorEdits(rotation=0.5), ActorEdits(rotation=-0.5)),
                "trans": (ActorEdits(lateral=2.0), ActorEdits(lateral=-2.0)),
            }
            for name, edit_list in actor_edits.items():
                fakes = [self._render_camera(ci, edits=edit) for edit in edit_list for ci in cams]
                metrics[f"fid_actor_shift_{name}"] = fid(real, fakes, device=self.device)
        for name, (lateral, vertical) in fid_suite_shifts(lane_sign).items():
            fakes = []
            for ci in cams:
                c2w = np.array(self.datamanager._camera_sample(ci).c2w, dtype=np.float32)
                c2w[:3, 3] += c2w[:3, 0] * lateral + c2w[:3, 1] * vertical
                fakes.append(self._render_eval_rgb(ci, c2w))
            metrics[f"fid_{name}"] = fid(real, fakes, device=self.device)
        return metrics
