"""AD pipeline (torch port of `neurad_tpu/pipelines/ad_pipeline.py`): builds
the NeuRAD model (or a nerfacto model) from parsed data, trains it on ray
batches, and renders full sensors chunk-wise (eval cameras and lidar scans,
the viewer's camera frame and virtual lidar).

The pipeline owns its model, and the model owns the parameters (the JAX
pipeline carries them in a TrainState). `init_state` makes the rest of the
training state: the per-group optimizers, the step count and the generator of
the step's random draws. `train_step` is the JAX package's
`make_train_step`: the loss (`loss_fn`), the backward (the hash-grid lookup's
backward kernel on a CUDA device), one update of every group. Random draws
are explicit (`TrainDraws`), taken from the state's generator unless a caller
passes them. Checkpoints hold the model, the optimizers, the step and both
generators' states, for an exact resume. `eval_metrics` and `eval_fid_suite`
score the eval split.

`model` "nerfacto" or "lidar-nerfacto" trains the nerfacto models on the same
batches: the rgb loss on the camera rays, no chunking and no VGG, the same
train step and checkpoints. The lidar variant's depth loss takes the lidar
rays' weights (the JAX package's pipeline hands the model's all-ray weights
with the lidar-only distances to the loss, and its step fails on any batch
with lidar rays). The JAX package cannot evaluate or render a nerfacto model
(its renders apply NeuRAD methods to it and raise AttributeError), so here
the renders, `eval_metrics` and `eval_fid_suite` raise NotImplementedError
for one.

Data-parallel training and eval run over a `torch.distributed` world (`mesh`,
`parallel/sharding.py`) with the JAX package's multi-host semantics: each rank
samples its own ray batch (seeded `host_local_seed`), every rank draws the
global batch's random draws from the same generator and keeps its own rows,
and the loss is the loss of the global batch `[all cam | all lidar]`, each
rank rendering, decoding and scoring its own rows with every loss term
reduced over the ranks (`make_sharded_train_step`). With `eval_shard` a full-sensor render is split
over the ranks chunk by chunk, and every rank gets the whole render.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.cameras.cameras import CameraType, Cameras, full_image_coords, generate_rays
from neurad_tpu_torch.core.math_utils import chamfer_distance
from neurad_tpu_torch.core.structs import RayBundle, map_tensors
from neurad_tpu_torch.data.datamanager import ADDataManager, ADDataManagerConfig
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs
from neurad_tpu_torch.engine.optimizers import (
    DEFAULT_GROUP_RULES,
    NEURAD_OPTIMIZER_GROUPS,
    OptimizerGroupConfig,
    Optimizers,
)
from neurad_tpu_torch.fields.neurad_encoding import ActorSettings, StaticSettings
from neurad_tpu_torch.model_components import losses as L
from neurad_tpu_torch.model_components.cnns import batch_statistics_over
from neurad_tpu_torch.model_components.dynamic_actors import (
    ActorEdits,
    actor_data_from_trajectories,
    empty_actor_data,
)
from neurad_tpu_torch.model_components.perceptual import load_vgg19_params
from neurad_tpu_torch.models.nerfacto import NerfactoModel
from neurad_tpu_torch.models.neurad import LossSettings, MLPProposalSettings, NeuRADModel, SamplingSettings
from neurad_tpu_torch.parallel import sharding
from neurad_tpu_torch.utils import profiler
from neurad_tpu_torch.utils.eval_metrics import fid, fid_suite_shifts, lpips

CHECKPOINT_PATTERN = "step-*.pt"
MODELS = ("neurad", "nerfacto", "lidar-nerfacto")
NERFACTO_EVAL_FAULT = (
    "the JAX package cannot evaluate or render a nerfacto model (its ADPipeline applies NeuRADModel methods to "
    "it: AttributeError, neurad_tpu/pipelines/ad_pipeline.py:303-401); a nerfacto eval would have to be added to "
    "both packages")
# the perceptual loss's VGG19 without NEURAD_TPU_VGG19_WEIGHTS: torch's generator from this seed, which is not
# the JAX package's network (drawn from jax.random.PRNGKey(1234)); the same weight file gives both the same one
VGG_SEED = 1234
# the settings types a model override may hold, by name (config.json stores them as dicts)
_SETTINGS = {t.__name__: t for t in (LossSettings, SamplingSettings, MLPProposalSettings, StaticSettings,
                                      ActorSettings)}


def _encode(value):
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return {"__settings__": type(value).__name__, **{k: _encode(v) for k, v in value._asdict().items()}}
    if isinstance(value, (tuple, list)):
        return {"__tuple__": [_encode(v) for v in value]}
    return value


def _decode(value):
    if isinstance(value, dict) and "__settings__" in value:
        fields = {k: _decode(v) for k, v in value.items() if k != "__settings__"}
        return _SETTINGS[value["__settings__"]](**fields)
    if isinstance(value, dict) and "__tuple__" in value:
        return tuple(_decode(v) for v in value["__tuple__"])
    return value


@dataclasses.dataclass
class ADPipelineConfig:
    datamanager: ADDataManagerConfig = dataclasses.field(default_factory=ADDataManagerConfig)
    model: str = "neurad"
    model_overrides: dict = dataclasses.field(default_factory=dict)
    optimizer_groups: dict = dataclasses.field(default_factory=lambda: dict(NEURAD_OPTIMIZER_GROUPS))
    # rays per chunk of a full-sensor render: bounds the hash-lookup intermediates
    eval_chunk: int = 1 << 15
    # in a data-parallel world, split a full-sensor render over the ranks (chunk by chunk); False: every rank
    # renders alone
    eval_shard: bool = True
    # rays per chunk of the train step's feature-field render (0: no chunking)
    train_ray_chunk: int = 8192
    seed: int = 0

    def to_dict(self) -> dict:
        """Plain nested dict (json-serialisable), the inverse of `from_dict`."""
        return dict(
            datamanager=dataclasses.asdict(self.datamanager), model=self.model,
            model_overrides={k: _encode(v) for k, v in self.model_overrides.items()},
            optimizer_groups={k: dataclasses.asdict(v) for k, v in self.optimizer_groups.items()},
            eval_chunk=self.eval_chunk, eval_shard=self.eval_shard, train_ray_chunk=self.train_ray_chunk,
            seed=self.seed,
        )

    @classmethod
    def from_dict(cls, d: dict) -> "ADPipelineConfig":
        return cls(
            datamanager=ADDataManagerConfig(**d["datamanager"]), model=d["model"],
            model_overrides={k: _decode(v) for k, v in d["model_overrides"].items()},
            optimizer_groups={k: OptimizerGroupConfig(**v) for k, v in d["optimizer_groups"].items()},
            eval_chunk=d["eval_chunk"], eval_shard=d.get("eval_shard", True), train_ray_chunk=d["train_ray_chunk"],
            seed=d["seed"],
        )


@dataclasses.dataclass
class TrainState:
    """What training carries besides the model's parameters."""

    step: int
    optimizers: Optimizers
    generator: torch.Generator  # the step's random draws


class ChunkDraws(NamedTuple):
    """One feature-field render's random draws: the sampler's uniform jitter
    per round ([R, 1] with single jitter, else [R, S + 1]) and the actor flip's
    uniform draw per ray [R] (None for a nerfacto model, which flips
    nothing)."""

    jitters: Tuple[torch.Tensor, ...]
    flip: Optional[torch.Tensor]


# a train step's draws: one ChunkDraws per chunk of `train_ray_chunk` rays (one when the batch is not chunked)
TrainDraws = List[ChunkDraws]


class ADPipeline:
    """Builds model + datamanager from dataparser outputs."""

    def __init__(self, outputs: ADDataparserOutputs, config: Optional[ADPipelineConfig] = None, device="cuda",
                 mesh: Optional[sharding.Mesh] = None):
        self.device = resolve_device(device)
        self.config = config or ADPipelineConfig()
        if self.config.model not in MODELS:
            raise ValueError(f"unknown model {self.config.model!r}; one of {MODELS}")
        self.outputs = outputs
        # the data-parallel world (None: one process): each rank samples its own rays, the model's seeds stay
        self.mesh = mesh
        rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
        self.datamanager = ADDataManager(outputs, self.config.datamanager, device=self.device,
                                         seed=sharding.host_local_seed(self.config.seed, rank))
        self.model = self._build_model(self.config.seed)
        self.num_cam_rays = self.datamanager.num_cam_rays
        # the train loss sees the global batch: every rank contributes num_cam_rays camera rays
        self._train_num_cam_rays = self.num_cam_rays * world
        self.patch_size = self.datamanager.patch_shape
        # the perceptual network, loaded once (pretrained weights from NEURAD_TPU_VGG19_WEIGHTS when that file
        # exists, else a fixed random network)
        self.vgg = None
        if not self._is_nerfacto and self.model.loss.vgg_mult > 0.0:
            self.vgg = load_vgg19_params(torch.Generator().manual_seed(VGG_SEED), device=self.device)

    @property
    def _is_nerfacto(self) -> bool:
        return self.config.model in ("nerfacto", "lidar-nerfacto")

    def _no_nerfacto(self) -> None:
        if self._is_nerfacto:
            raise NotImplementedError(f"{self.config.model}: {NERFACTO_EVAL_FAULT}")

    def _build_model(self, seed: int) -> nn.Module:
        outputs = self.outputs
        # the hash tables are drawn on the device from `generator`; the small dense layers on the host from
        # torch's default generator, seeded for the construction only
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if self._is_nerfacto:
            model_kwargs = dict(aabb=np.asarray(outputs.scene_box.aabb).tolist(), num_images=len(outputs.images),
                                use_lidar_losses=self.config.model == "lidar-nerfacto")
            model_kwargs.update(self.config.model_overrides)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = NerfactoModel(generator=generator, **model_kwargs)
            return model.to(self.device).eval()
        actor_data = (
            actor_data_from_trajectories(outputs.trajectories) if outputs.trajectories else empty_actor_data()
        )
        model_kwargs = dict(
            actor_data=actor_data,
            static_scale=float(np.abs(np.asarray(outputs.scene_box.aabb)).max()),
            num_sensors=len(outputs.sensor_idx_to_name),
            duration=outputs.duration,
            num_train_images=len(outputs.images),
            rgb_upsample_factor=self.config.datamanager.rgb_upsample_factor,
        )
        model_kwargs.update(self.config.model_overrides)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = NeuRADModel(generator=generator, **model_kwargs)
        return model.to(self.device).eval()

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """The training state around the model's parameters. As in the JAX
        package, one training batch is drawn first (and dropped), so that the
        batches that follow are the JAX package's."""
        self.datamanager.next_train()
        generator = torch.Generator(device=self.device).manual_seed(self.config.seed if seed is None else seed)
        optimizers = Optimizers(self.model.named_parameters(), self.config.optimizer_groups, DEFAULT_GROUP_RULES)
        return TrainState(step=0, optimizers=optimizers, generator=generator)

    def _chunks(self, n_rays: int) -> List[int]:
        """Ray counts of the train step's feature-field renders (a nerfacto
        model renders its batch whole)."""
        chunk = self.config.train_ray_chunk
        if chunk and n_rays > chunk and not self._is_nerfacto:
            return [chunk] * math.ceil(n_rays / chunk)
        return [n_rays]

    def draw(self, generator: torch.Generator, n_rays: int) -> TrainDraws:
        """A train step's draws from `generator`, chunk by chunk: per proposal
        round and the field's round one uniform jitter tensor, then the flip
        (none for a nerfacto model, whose sampler always jitters singly)."""
        if self._is_nerfacto:
            rounds = len(self.model.num_proposal_samples) + 1
            return [ChunkDraws(tuple(torch.rand((n_rays, 1), generator=generator, device=self.device)
                                     for _ in range(rounds)), None)]
        sampling = self.model.sampling
        counts = list(sampling.num_proposal_samples) + [sampling.num_nerf_samples]
        draws = []
        for r in self._chunks(n_rays):
            jitters = tuple(
                torch.rand((r, 1 if sampling.single_jitter else s + 1), generator=generator, device=self.device)
                for s in counts
            )
            draws.append(ChunkDraws(jitters, torch.rand((r,), generator=generator, device=self.device)))
        return draws

    def loss_fn(self, bundle: RayBundle, batch: Dict[str, torch.Tensor], draws: TrainDraws
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of one batch. Above `train_ray_chunk` rays the
        feature-field render runs chunk by chunk (modality from the rays'
        `is_lidar`; the last chunk padded by repeating the last ray) and the
        features are decoded once; otherwise `get_outputs` runs on the batch."""
        n = bundle.origins.shape[0]
        chunks = self._chunks(n)
        if len(draws) != len(chunks):
            raise ValueError(f"{len(draws)} sets of draws for {len(chunks)} chunks")
        return self._loss_of_outputs(self._ray_outputs(bundle, draws, self.num_cam_rays), batch, self.num_cam_rays)

    def _ray_outputs(self, bundle: RayBundle, draws: TrainDraws, num_cam_rays: int) -> Dict:
        """The per-ray part of the training forward: the feature-field render
        (chunk by chunk above `train_ray_chunk` rays), or a nerfacto model's
        outputs. Every tensor is per ray ([R, ...]), in dicts and lists."""
        model = self.model
        n = bundle.origins.shape[0]
        chunks = self._chunks(n)
        if self._is_nerfacto:
            return model.get_outputs(bundle, train=True, jitters=draws[0].jitters)
        if len(chunks) == 1:
            d = draws[0]
            return model.get_nff_outputs(bundle, num_cam_rays, jitters=d.jitters, flip_draw=d.flip, train=True)
        chunk = chunks[0]
        total = chunk * len(chunks)
        padded = map_tensors(lambda x: torch.cat([x, x[-1:].expand((total - n,) + x.shape[1:])], dim=0), bundle)
        outs = []
        for i, d in enumerate(draws):
            with profiler.span("pipeline.chunk", index=i):
                piece = map_tensors(lambda x: x[i * chunk:(i + 1) * chunk], padded)
                outs.append(model.get_nff_outputs(piece, 0, jitters=d.jitters, flip_draw=d.flip, train=True))
        return {k: torch.cat([o[k] for o in outs], dim=0)[:n] for k in outs[0]}

    def _loss_of_outputs(self, out: Dict, batch: Dict[str, torch.Tensor], num_cam_rays: int,
                         terms: Optional[L.BatchTerms] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss of a batch's per-ray outputs (`_ray_outputs`): NeuRAD
        decodes the features (camera patches, lidar rays) first. `terms`:
        NeuRAD's reductions (`compute_losses`)."""
        if self._is_nerfacto:
            return self._nerfacto_loss(out, batch, num_cam_rays)
        with profiler.span("model.losses"):
            out = dict(out)
            features = out.pop("features")
            rgb, intensity, ray_drop_logits = self.model.decode_features(features, self.patch_size, num_cam_rays,
                                                                          train=True)
            if rgb is not None:
                out["rgb"] = rgb
            if intensity is not None:
                out["intensity"] = intensity
                out["ray_drop_logits"] = ray_drop_logits
            return self.model.compute_losses(out, batch, num_cam_rays, vgg=self.vgg, terms=terms)

    def _nerfacto_loss(self, out: Dict, batch: Dict[str, torch.Tensor], n_cam: int
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A nerfacto model's loss: the rgb and the image of the camera rays
        (one ray a pixel), the depth loss from the lidar rays' weights."""
        out = dict(out)
        batch = dict(batch)
        if "image" in batch:
            batch["image"] = batch["image"].reshape(-1, 3)[:n_cam]
            out["rgb"] = out["rgb"][:n_cam]
        if "distance" in batch and "weights" in out:
            out["weights"] = out["weights"][n_cam:]
            out["ray_samples_mids"] = out["ray_samples_mids"][n_cam:]
        return self.model.compute_losses(out, batch)

    def train_step(self, state: TrainState, bundle: RayBundle, batch: Dict[str, torch.Tensor],
                   draws: Optional[TrainDraws] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer update: loss, backward, every group's step. Metrics
        are detached tensors on the model's device."""
        with profiler.span("train.forward"):
            if draws is None:
                draws = self.draw(state.generator, bundle.origins.shape[0])
            total, metrics = self.loss_fn(bundle, batch, draws)
        with profiler.span("train.backward"):
            state.optimizers.zero_grad()
            total.backward()
        with profiler.span("train.optimizer"):
            state.optimizers.step()
        state.step += 1
        metrics = dict(metrics)
        metrics["total_loss"] = total.detach()
        return state, metrics

    # ------------------------------------------------------------------
    # data-parallel training
    # ------------------------------------------------------------------

    def _rank_draws(self, draws: TrainDraws, rows: torch.Tensor, n_global: int, n_local: int) -> TrainDraws:
        """A rank's share of the global batch's draws: each ray's draws taken
        at its row of the global batch, chunked as the rank's own batch is
        (the last chunk padded by repeating its last ray's draws)."""
        rows = rows.to(self.device)
        take = lambda ts: torch.cat(ts, dim=0)[:n_global][rows]
        jitters = tuple(take([d.jitters[k] for d in draws]) for k in range(len(draws[0].jitters)))
        flip = take([d.flip for d in draws]) if draws[0].flip is not None else None
        chunks = self._chunks(n_local)
        if len(chunks) == 1:
            return [ChunkDraws(jitters, flip)]
        chunk, total = chunks[0], chunks[0] * len(chunks)
        pad = lambda x: torch.cat([x, x[-1:].expand((total - n_local,) + x.shape[1:])], dim=0)
        jitters, flip = tuple(pad(j) for j in jitters), (pad(flip) if flip is not None else None)
        return [ChunkDraws(tuple(j[i * chunk:(i + 1) * chunk] for j in jitters),
                           flip[i * chunk:(i + 1) * chunk] if flip is not None else None)
                for i in range(len(chunks))]

    def make_sharded_train_step(self, mesh: Optional[sharding.Mesh] = None):
        """train_step_sharded(state, bundle, batch, draws=None) over `mesh`
        (default: the pipeline's). Each rank passes its own `[cam | lidar]`
        batch. Every rank draws the global batch's draws (`draws`: the
        global batch's, one per chunk of it) and keeps its rows of the global
        batch `[cam_0 .. cam_{w-1} | lidar_0 .. lidar_{w-1}]`, renders its
        rays (the feature field and the hash-grid kernels), decodes its own
        patches and lidar rays and scores them: each loss term is reduced
        over the ranks (`sharding.GlobalBatchTerms`; a batch-norm decoder
        takes the global batch's statistics), so the loss is the one-process
        loss of the global batch while a rank's decoder, VGG and loss work
        stay its own batch's. The parameter gradients are averaged over the
        ranks. A nerfacto model's loss is per-ray arithmetic without a
        decoder: its per-ray outputs and the ground truth are gathered and
        every rank scores the global batch."""
        mesh = mesh or self.mesh
        if mesh is None:
            raise ValueError("make_sharded_train_step needs a mesh")
        w, rank = mesh.world_size, mesh.rank

        def gather(tree, rows, n_global):
            if isinstance(tree, dict):
                return {k: gather(v, rows, n_global) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(gather(v, rows, n_global) for v in tree)
            if tree is None:
                return None
            return sharding.gather_rows_with_grad(mesh, tree, rows, n_global)

        def run(state: TrainState, bundle: RayBundle, batch: Dict[str, torch.Tensor],
                draws: Optional[TrainDraws] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            n_local = bundle.origins.shape[0]
            n_cam = self.num_cam_rays
            sharding.same_on_every_rank(mesh, float(n_local), "the ray batch's size")
            n_global = n_local * w
            if draws is None:
                draws = self.draw(state.generator, n_global)
            if len(draws) != len(self._chunks(n_global)):
                raise ValueError(f"{len(draws)} sets of draws for {len(self._chunks(n_global))} chunks")
            rows = sharding.train_batch_rows(rank, w, n_cam, n_local - n_cam)
            out = self._ray_outputs(bundle, self._rank_draws(draws, rows, n_global, n_local), n_cam)
            if self._is_nerfacto:
                total, metrics = self._loss_of_outputs(gather(out, rows, n_global), sharding.gather_blocks(mesh, batch),
                                                       self._train_num_cam_rays)
            else:
                terms = sharding.GlobalBatchTerms(mesh)
                with batch_statistics_over(terms.of_mean):
                    total, metrics = self._loss_of_outputs(out, batch, n_cam, terms)
            state.optimizers.zero_grad()
            total.backward()
            sharding.all_reduce_gradients(mesh, sharding.optimizer_params(state.optimizers))
            state.optimizers.step()
            state.step += 1
            metrics = dict(metrics)
            metrics["total_loss"] = total.detach()
            return state, metrics

        return run

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, state: TrainState, checkpoint_dir) -> Optional[Path]:
        """Write `step-<step>.pt`: the model's state dict, the optimizers'
        state, the step, the generator's and the datamanager sampler's state.
        In a data-parallel world every rank's sampler state is gathered
        (`datamanager_rng_ranks`, the ranks sample different rays; rank 0's is
        also `datamanager_rng`), rank 0 writes (the others return None) and
        every rank waits for the file."""
        rank_states = None
        if self.mesh is not None:
            rank_states = sharding.gather_objects(self.mesh, self.datamanager.rng_state())
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
                "datamanager_rng_ranks": rank_states,
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
        rank_states = ckpt.get("datamanager_rng_ranks")
        if self.mesh is not None and rank_states is not None:
            if len(rank_states) != self.mesh.world_size:
                raise ValueError(f"the checkpoint holds the samplers of {len(rank_states)} ranks, "
                                 f"not {self.mesh.world_size}")
            self.datamanager.set_rng_state(rank_states[self.mesh.rank])
        else:
            self.datamanager.set_rng_state(ckpt["datamanager_rng"])
        return state

    # ------------------------------------------------------------------
    # chunked feature-field render
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _chunked_nff(self, bundle: RayBundle, all_camera: bool, edits: Optional[ActorEdits] = None
                     ) -> Dict[str, torch.Tensor]:
        """The model's feature-field render over a flat bundle, `eval_chunk`
        rays at a time. `all_camera` decides the pixel-area scaling (a whole
        bundle is one modality at eval). The last chunk is padded with zero
        rays to the chunk's size, as the JAX pipeline pads it: the capacity of
        the compacted actor lookup depends on the chunk's size. Outputs are
        trimmed."""
        chunk = self.config.eval_chunk
        n = bundle.origins.shape[0]
        if self._eval_sharded():
            return self._chunked_nff_sharded(bundle, all_camera, edits)
        outs = []
        for start in range(0, n, chunk):
            with profiler.span("pipeline.chunk", index=start // chunk):
                piece = map_tensors(lambda x: x[start : start + chunk], bundle)
                m = piece.origins.shape[0]
                if m < chunk:
                    piece = map_tensors(lambda x: torch.cat([x, x.new_zeros((chunk - m,) + x.shape[1:])], dim=0),
                                        piece)
                out = self.model.get_nff_outputs(piece, chunk if all_camera else 0, edits=edits)
                outs.append({k: v[:m] for k, v in out.items()})
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

    def _eval_sharded(self) -> bool:
        return self.mesh is not None and self.mesh.world_size > 1 and self.config.eval_shard

    @torch.no_grad()
    def _chunked_nff_sharded(self, bundle: RayBundle, all_camera: bool, edits: Optional[ActorEdits] = None
                             ) -> Dict[str, torch.Tensor]:
        """`_chunked_nff` split over the data-parallel world: super-chunks of
        `eval_chunk * world_size` rays, rank r rendering the super-chunk's
        r-th chunk (padded with zero rays to the chunk's size, as one process
        pads its last chunk, so each chunk is rendered as one process renders
        it), and the chunks gathered (an all-reduce of a zero-filled buffer),
        so that every rank holds the whole render."""
        mesh, chunk = self.mesh, self.config.eval_chunk
        n = bundle.origins.shape[0]
        outs = []
        for start in range(0, n, chunk * mesh.world_size):
            rows = min(chunk * mesh.world_size, n - start)
            mine = start + mesh.rank * chunk
            piece = map_tensors(lambda x: x[mine:min(mine + chunk, n)], bundle)
            m = piece.origins.shape[0]
            if m < chunk:
                piece = map_tensors(lambda x: torch.cat([x, x.new_zeros((chunk - m,) + x.shape[1:])], dim=0), piece)
            out = self.model.get_nff_outputs(piece, chunk if all_camera else 0, edits=edits)
            idx = torch.arange(mesh.rank * chunk, mesh.rank * chunk + m)
            outs.append({k: sharding.gather_rows(mesh, v[:m], idx, rows) for k, v in out.items()})
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

    def _eval_params(self) -> None:
        """Before a sharded render: rank 0's parameters on every rank,
        checked bit for bit (the JAX package replicates them onto the mesh)."""
        if self._eval_sharded():
            sharding.replicate(self.mesh, self.model)

    # ------------------------------------------------------------------
    # evaluation renders
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _render_camera(self, cam_idx: int, edits: Optional[ActorEdits] = None, shift: Optional[np.ndarray] = None
                       ) -> Tuple[torch.Tensor, np.ndarray]:
        """An eval camera's full-image render -> (pred rgb [H', W', 3] on the
        device, gt rgb). `edits`: actor edits applied at render time; `shift`:
        a world offset [3] added to every ray's origin."""
        with profiler.span("pipeline.rays"):
            bundle, gt, (hs, ws) = self.datamanager.eval_camera_bundle(cam_idx)
        if shift is not None:
            bundle = bundle.replace(origins=bundle.origins + torch.as_tensor(shift, device=self.device))
        nff = self._chunked_nff(bundle, all_camera=True, edits=edits)
        rgb = self.model.decode_features(nff["features"], (hs, ws), hs * ws)[0]
        return rgb[0], gt

    @torch.no_grad()
    def render_eval_camera(self, cam_idx: int, edits: Optional[ActorEdits] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Full-image render -> (pred rgb [H', W', 3], gt rgb). `edits`: actor
        edits applied at render time."""
        self._no_nerfacto()
        self._eval_params()
        rgb, gt = self._render_camera(cam_idx, edits)
        with profiler.span("pipeline.to_host"):
            return rgb.cpu().numpy(), gt

    @torch.no_grad()
    def _render_lidar(self, scan_idx: int) -> Dict[str, torch.Tensor]:
        """An eval scan's render and its ground truth, on the device."""
        bundle, pts = self.datamanager.eval_lidar_bundle(scan_idx)
        nff = self._chunked_nff(bundle, all_camera=False)
        _, intensity, ray_drop = self.model.decode_features(nff["features"], (1, 1), 0)
        return {
            "depth": nff["depth"],
            "intensity": intensity,
            "ray_drop_logits": ray_drop,
            "gt_distance": bundle.metadata["directions_norm"],
            "gt_intensity": torch.as_tensor(pts[:, 3:4], device=self.device),
            "did_return": bundle.metadata["did_return"],
            "origins": bundle.origins,
            "directions": bundle.directions,
        }

    @torch.no_grad()
    def render_eval_lidar(self, scan_idx: int) -> Dict[str, np.ndarray]:
        self._no_nerfacto()
        self._eval_params()
        return {k: v.cpu().numpy() for k, v in self._render_lidar(scan_idx).items()}

    # ------------------------------------------------------------------
    # viewer renders
    # ------------------------------------------------------------------

    @staticmethod
    def _viewer_edits(edits_vec) -> ActorEdits:
        """(lateral, longitudinal, rotation, height) -> ActorEdits of every
        actor; a fifth element (another model's) is ignored."""
        ev = [0.0] * 4 if edits_vec is None else [float(v) for v in np.asarray(edits_vec, np.float32)[:4]]
        return ActorEdits(lateral=ev[0], longitudinal=ev[1], rotation=ev[2], height=ev[3], index=-1)

    @torch.no_grad()
    def render_viewer_image(self, c2w: np.ndarray, width: int, height: int, time: float, edits_vec=None) -> np.ndarray:
        """Full-frame render for the live viewer from a free camera (focal
        0.7 * width, one ray per pixel) -> [height * up, width * up, 3]."""
        self._no_nerfacto()
        dev = self.device
        focal = 0.7 * width
        full = lambda v, dtype=torch.float32: torch.full((1, 1), v, dtype=dtype, device=dev)
        cams = Cameras(
            camera_to_worlds=torch.as_tensor(np.array(c2w, np.float32), device=dev)[None],
            fx=full(focal), fy=full(focal), cx=full(width / 2.0), cy=full(height / 2.0),
            width=full(width, torch.int32), height=full(height, torch.int32),
            camera_type=full(int(CameraType.PERSPECTIVE), torch.int32),
            times=full(float(time)),
        )
        coords = full_image_coords(height, width, device=dev)
        bundle = generate_rays(cams, torch.zeros(coords.shape[0], dtype=torch.long, device=dev), coords)
        nff = self.model.get_nff_outputs(bundle, bundle.origins.shape[0], edits=self._viewer_edits(edits_vec))
        rgb = self.model.decode_features(nff["features"], (height, width), height * width)[0]
        return rgb[0].cpu().numpy()

    @torch.no_grad()
    def render_virtual_lidar(
        self, origin: np.ndarray, time: float, channels: int = 32, azim_res_deg: float = 1.0, fov_up: float = 5.0,
        fov_down: float = -15.0, drop_threshold: float = 0.5, edits_vec=None,
    ) -> np.ndarray:
        """Virtual-lidar point cloud for the viewer: a spherical scan at
        `origin` rendered through the model; points whose predicted ray-drop
        probability is below the threshold are kept -> [N, 4] (world xyz +
        intensity)."""
        self._no_nerfacto()
        elev = np.deg2rad(np.linspace(fov_down, fov_up, channels))
        azim = np.deg2rad(np.arange(-180.0, 180.0, azim_res_deg))
        el, azm = np.meshgrid(elev, azim, indexing="ij")
        dirs = np.stack(
            [np.cos(el) * np.cos(azm), np.cos(el) * np.sin(azm), np.sin(el)], axis=-1
        ).reshape(-1, 3).astype(np.float32)
        n, dev = dirs.shape[0], self.device
        bundle = RayBundle(
            origins=torch.as_tensor(np.asarray(origin, np.float32), device=dev).expand(n, 3),
            directions=torch.from_numpy(dirs).to(dev),
            pixel_area=torch.full((n, 1), 1e-6, device=dev),
            camera_indices=torch.zeros((n, 1), dtype=torch.long, device=dev),
            times=torch.full((n, 1), float(time), device=dev),
            metadata={
                "directions_norm": torch.ones((n, 1), device=dev),
                "is_lidar": torch.ones((n, 1), dtype=torch.bool, device=dev),
                "sensor_idxs": torch.zeros((n, 1), dtype=torch.long, device=dev),
            },
        )
        nff = self.model.get_nff_outputs(bundle, 0, edits=self._viewer_edits(edits_vec))
        _, intensity, ray_drop = self.model.decode_features(nff["features"], (1, 1), 0)
        depth, intensity = nff["depth"].cpu().numpy(), intensity.cpu().numpy()
        keep = 1.0 / (1.0 + np.exp(-ray_drop.cpu().numpy()[:, 0])) < drop_threshold
        pts = np.asarray(origin)[None] + dirs * depth
        return np.concatenate([pts, intensity], axis=-1)[keep]

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _actor_pixel_mask(self, cam_idx: int, hs: int, ws: int) -> Optional[np.ndarray]:
        """[hs, ws] bool mask (host numpy) of the pixels that the projected
        boxes of the actors present at the camera's time cover, at the
        render's resolution; None for a scene without actors."""
        ad = self.model.actors.data
        if ad.n_actors == 0:
            return None
        cams = self.outputs.cameras
        host = lambda x: np.asarray(x.cpu() if torch.is_tensor(x) else x)
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3] = host(cams.camera_to_worlds[cam_idx])
        t = 0.0
        if cams.times is not None:
            t = float(host(cams.times[cam_idx]).reshape(-1)[0])
        ti = int(np.argmin(np.abs(ad.unique_timestamps - t)))
        sx = ws / float(host(cams.width[cam_idx]).reshape(-1)[0])
        sy = hs / float(host(cams.height[cam_idx]).reshape(-1)[0])
        fx = float(host(cams.fx[cam_idx]).reshape(-1)[0]) * sx
        fy = float(host(cams.fy[cam_idx]).reshape(-1)[0]) * sy
        cx = float(host(cams.cx[cam_idx]).reshape(-1)[0]) * sx
        cy = float(host(cams.cy[cam_idx]).reshape(-1)[0]) * sy

        r_wc = c2w[:3, :3].T
        t_w = c2w[:3, 3]
        mask = np.zeros((hs, ws), dtype=bool)
        corners_unit = np.array(
            [[sx_, sy_, sz_] for sx_ in (-1, 1) for sy_ in (-1, 1) for sz_ in (-1, 1)], dtype=np.float64
        )
        for a in range(ad.n_actors):
            if not ad.present[ti, a]:
                continue
            b2w = ad.poses[ti, a]
            half = np.asarray(ad.sizes[a], dtype=np.float64) / 2.0
            corners_w = (b2w[:3, :3] @ (corners_unit * half).T).T + b2w[:3, 3]
            p_cam = (r_wc @ (corners_w - t_w).T).T  # the camera looks down -z, y up
            z = -p_cam[:, 2]
            if (z <= 0.1).all():
                continue
            z = np.clip(z, 0.1, None)
            us = cx + fx * p_cam[:, 0] / z
            vs = cy - fy * p_cam[:, 1] / z
            u0, u1 = int(np.floor(us.min())), int(np.ceil(us.max()))
            v0, v1 = int(np.floor(vs.min())), int(np.ceil(vs.max()))
            u0, u1 = max(u0, 0), min(u1, ws)
            v0, v1 = max(v0, 0), min(v1, hs)
            if u1 > u0 and v1 > v0:
                mask[v0:v1, u0:u1] = True
        return mask

    @torch.no_grad()
    def eval_metrics(self) -> Dict[str, float]:
        """Over the eval cameras: PSNR, SSIM and LPIPS, and the PSNR of the
        pixels under actor boxes weighted by their coverage (`actor_psnr`,
        `actor_coverage`). Over the eval scans' returns: the median and the
        relative squared depth error, the intensity RMSE, the ray-drop
        accuracy and the chamfer distance between the predicted and the
        measured points (the measured points' mean range where every ray is
        predicted dropped). On the device; np.median on the host."""
        self._no_nerfacto()
        self._eval_params()
        metrics: Dict[str, float] = {}
        cams = self.outputs.eval_camera_indices
        if cams:
            if self.vgg is None:  # the LPIPS fallback's network, kept for the FID suite's actor edits (as in JAX)
                self.vgg = load_vgg19_params(torch.Generator().manual_seed(VGG_SEED), device=self.device)
            psnrs, ssims, lpipss = [], [], []
            actor_psnrs, actor_covs = [], []
            for ci in cams:
                pred, gt = self._render_camera(ci)
                gt = torch.as_tensor(gt, device=self.device)
                psnrs.append(float(L.psnr(pred, gt)))
                ssims.append(float(L.ssim(pred, gt)))
                lpipss.append(float(lpips(self.vgg, pred, gt)))
                amask = self._actor_pixel_mask(ci, pred.shape[0], pred.shape[1])
                if amask is not None and amask.any():
                    m = torch.as_tensor(amask, device=self.device)
                    mse = float(torch.mean((pred[m] - gt[m]) ** 2))
                    actor_psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
                    actor_covs.append(float(amask.mean()))
            metrics["psnr"] = float(np.mean(psnrs))
            metrics["ssim"] = float(np.mean(ssims))
            metrics["lpips"] = float(np.mean(lpipss))
            if actor_covs:
                w = np.asarray(actor_covs)
                metrics["actor_psnr"] = float(np.sum(np.asarray(actor_psnrs) * w) / w.sum())
                metrics["actor_coverage"] = float(np.mean(w))
        scans = self.outputs.eval_lidar_indices
        if scans:
            med_l2, rel_l2, int_rmse, drop_acc, chamfers = [], [], [], [], []
            for si in scans:
                out = self._render_lidar(si)
                ret = out["did_return"][:, 0]
                depth, dist = out["depth"][ret], out["gt_distance"][ret]
                err2 = (depth - dist) ** 2
                med_l2.append(float(np.median(err2.cpu().numpy())))
                rel_l2.append(float(torch.mean(err2 / (dist**2).clamp_min(1e-6))))
                int_rmse.append(float(torch.sqrt(torch.mean((out["intensity"][ret] - out["gt_intensity"][ret]) ** 2))))
                pred_drop = 1.0 / (1.0 + torch.exp(-out["ray_drop_logits"][:, 0])) > 0.5
                drop_acc.append(float(torch.mean((pred_drop == ~ret).float())))
                pred_pts = out["origins"] + out["directions"] * out["depth"]
                gt_pts = out["origins"] + out["directions"] * out["gt_distance"]
                if bool((~pred_drop).any()) and bool(ret.any()):
                    chamfers.append(float(chamfer_distance(pred_pts, gt_pts, pred_mask=~pred_drop, gt_mask=ret)))
                else:  # every ray predicted dropped
                    chamfers.append(float(torch.linalg.norm(gt_pts[ret], dim=-1).mean()))
            metrics["depth_median_l2"] = float(np.mean(med_l2))
            metrics["depth_mean_rel_l2"] = float(np.mean(rel_l2))
            metrics["intensity_rmse"] = float(np.mean(int_rmse))
            metrics["ray_drop_accuracy"] = float(np.mean(drop_acc))
            metrics["chamfer_distance"] = float(np.mean(chamfers))
        return metrics

    @torch.no_grad()
    def eval_fid_suite(self, max_images: Optional[int] = None) -> Dict[str, float]:
        """Novel-view FID of the first `max_images` eval cameras (all by
        default) against their images: actor edits (rotation +-0.5 rad,
        lateral +-2 m, both signs pooled; the features of `eval_metrics`'
        VGG19 once it has run) where the scene has actors, then lane shifts
        of 2 and 3 m (signed by the sequence's `lane_shift_sign`) and a
        vertical shift of 1 m, each moving every ray's origin along the
        camera's right or up axis."""
        self._no_nerfacto()
        self._eval_params()
        lane_sign = 1
        if self.outputs.metadata and "lane_shift_sign" in self.outputs.metadata:
            lane_sign = int(self.outputs.metadata["lane_shift_sign"])
        cams = list(self.outputs.eval_camera_indices)
        if max_images is not None:
            cams = cams[:max_images]
        if not cams:
            return {}
        real = [self.datamanager.eval_camera_bundle(ci)[1] for ci in cams]
        metrics: Dict[str, float] = {}
        if self.model.actors.data.n_actors > 0:
            actor_edits = {
                "rot": (ActorEdits(rotation=0.5), ActorEdits(rotation=-0.5)),
                "trans": (ActorEdits(lateral=2.0), ActorEdits(lateral=-2.0)),
            }
            for name, edit_list in actor_edits.items():
                fakes = [self._render_camera(ci, edits=edit)[0] for edit in edit_list for ci in cams]
                metrics[f"fid_actor_shift_{name}"] = fid(real, fakes, vgg=self.vgg, device=self.device)
        for name, (lateral, vertical) in fid_suite_shifts(lane_sign).items():
            fakes = []
            for ci in cams:
                c2w = self.outputs.cameras.camera_to_worlds[ci].cpu().numpy()
                fakes.append(self._render_camera(ci, shift=c2w[:3, 0] * lateral + c2w[:3, 1] * vertical)[0])
            metrics[f"fid_{name}"] = fid(real, fakes, device=self.device)
        return metrics
