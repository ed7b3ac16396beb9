"""AD pipeline (torch port of `neurad_tpu/pipelines/ad_pipeline.py`): builds
the NeuRAD model from parsed data, trains it on ray batches, and renders full
sensors chunk-wise (eval cameras and lidar scans, the viewer's camera frame
and virtual lidar).

The pipeline owns its model, and the model owns the parameters (the JAX
pipeline carries them in a TrainState). `init_state` makes the rest of the
training state: the per-group optimizers, the step count and the generator of
the step's random draws. `train_step` is the JAX package's
`make_train_step`: the loss (`loss_fn`), the backward (the hash-grid lookup's
backward kernel on a CUDA device), one update of every group. Random draws
are explicit (`TrainDraws`), taken from the state's generator unless a caller
passes them. Checkpoints hold the model, the optimizers, the step and both
generators' states, for an exact resume. The nerfacto models, the FID suite,
the mesh-sharded eval and the batched multi-host steps are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.cameras.cameras import CameraType, Cameras, full_image_coords, generate_rays
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
from neurad_tpu_torch.model_components.dynamic_actors import (
    ActorEdits,
    actor_data_from_trajectories,
    empty_actor_data,
)
from neurad_tpu_torch.model_components.perceptual import load_vgg19_params
from neurad_tpu_torch.models.neurad import LossSettings, MLPProposalSettings, NeuRADModel, SamplingSettings

CHECKPOINT_PATTERN = "step-*.pt"
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
    # rays per chunk of the train step's feature-field render (0: no chunking)
    train_ray_chunk: int = 8192
    seed: int = 0

    def to_dict(self) -> dict:
        """Plain nested dict (json-serialisable), the inverse of `from_dict`."""
        return dict(
            datamanager=dataclasses.asdict(self.datamanager), model=self.model,
            model_overrides={k: _encode(v) for k, v in self.model_overrides.items()},
            optimizer_groups={k: dataclasses.asdict(v) for k, v in self.optimizer_groups.items()},
            eval_chunk=self.eval_chunk, train_ray_chunk=self.train_ray_chunk, seed=self.seed,
        )

    @classmethod
    def from_dict(cls, d: dict) -> "ADPipelineConfig":
        return cls(
            datamanager=ADDataManagerConfig(**d["datamanager"]), model=d["model"],
            model_overrides={k: _decode(v) for k, v in d["model_overrides"].items()},
            optimizer_groups={k: OptimizerGroupConfig(**v) for k, v in d["optimizer_groups"].items()},
            eval_chunk=d["eval_chunk"], train_ray_chunk=d["train_ray_chunk"], seed=d["seed"],
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
    uniform draw per ray [R]."""

    jitters: Tuple[torch.Tensor, ...]
    flip: torch.Tensor


# a train step's draws: one ChunkDraws per chunk of `train_ray_chunk` rays (one when the batch is not chunked)
TrainDraws = List[ChunkDraws]


class ADPipeline:
    """Builds model + datamanager from dataparser outputs."""

    def __init__(self, outputs: ADDataparserOutputs, config: Optional[ADPipelineConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.config = config or ADPipelineConfig()
        if self.config.model != "neurad":
            raise NotImplementedError(f"model {self.config.model!r} is not ported; only 'neurad' is")
        self.outputs = outputs
        self.datamanager = ADDataManager(outputs, self.config.datamanager, device=self.device, seed=self.config.seed)
        self.model = self._build_model(self.config.seed)
        self.num_cam_rays = self.datamanager.num_cam_rays
        self.patch_size = self.datamanager.patch_shape
        # the perceptual network, loaded once (pretrained weights from NEURAD_TPU_VGG19_WEIGHTS when that file
        # exists, else a fixed random network)
        self.vgg = None
        if self.model.loss.vgg_mult > 0.0:
            self.vgg = load_vgg19_params(torch.Generator().manual_seed(VGG_SEED), device=self.device)

    def _build_model(self, seed: int) -> NeuRADModel:
        outputs = self.outputs
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
        # the hash tables are drawn on the device from `generator`; the small dense layers on the host from
        # torch's default generator, seeded for the construction only
        generator = torch.Generator(device=self.device).manual_seed(seed)
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
        """Ray counts of the train step's feature-field renders."""
        chunk = self.config.train_ray_chunk
        if chunk and n_rays > chunk:
            return [chunk] * math.ceil(n_rays / chunk)
        return [n_rays]

    def draw(self, generator: torch.Generator, n_rays: int) -> TrainDraws:
        """A train step's draws from `generator`, chunk by chunk: per proposal
        round and the field's round one uniform jitter tensor, then the flip."""
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
        model = self.model
        n = bundle.origins.shape[0]
        chunks = self._chunks(n)
        if len(draws) != len(chunks):
            raise ValueError(f"{len(draws)} sets of draws for {len(chunks)} chunks")
        if len(chunks) > 1:
            chunk = chunks[0]
            total = chunk * len(chunks)
            padded = map_tensors(lambda x: torch.cat([x, x[-1:].expand((total - n,) + x.shape[1:])], dim=0), bundle)
            outs = []
            for i, d in enumerate(draws):
                piece = map_tensors(lambda x: x[i * chunk:(i + 1) * chunk], padded)
                outs.append(model.get_nff_outputs(piece, 0, jitters=d.jitters, flip_draw=d.flip, train=True))
            out = {k: torch.cat([o[k] for o in outs], dim=0)[:n] for k in outs[0]}
            features = out.pop("features")
            rgb, intensity, ray_drop_logits = model.decode_features(features, self.patch_size, self.num_cam_rays)
            out["rgb"] = rgb
            if intensity is not None:
                out["intensity"] = intensity
                out["ray_drop_logits"] = ray_drop_logits
        else:
            d = draws[0]
            out = model.get_outputs(bundle, self.patch_size, self.num_cam_rays, jitters=d.jitters, flip_draw=d.flip,
                                    train=True)
        return model.compute_losses(out, batch, self.num_cam_rays, vgg=self.vgg)

    def train_step(self, state: TrainState, bundle: RayBundle, batch: Dict[str, torch.Tensor],
                   draws: Optional[TrainDraws] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer update: loss, backward, every group's step. Metrics
        are detached tensors on the model's device."""
        if draws is None:
            draws = self.draw(state.generator, bundle.origins.shape[0])
        total, metrics = self.loss_fn(bundle, batch, draws)
        state.optimizers.zero_grad()
        total.backward()
        state.optimizers.step()
        state.step += 1
        metrics = dict(metrics)
        metrics["total_loss"] = total.detach()
        return state, metrics

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, state: TrainState, checkpoint_dir) -> Path:
        """Write `step-<step>.pt`: the model's state dict, the optimizers'
        state, the step, the generator's and the datamanager sampler's state."""
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
            },
            tmp,
        )
        tmp.replace(path)
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
        outs = []
        for start in range(0, n, chunk):
            piece = map_tensors(lambda x: x[start : start + chunk], bundle)
            m = piece.origins.shape[0]
            if m < chunk:
                piece = map_tensors(lambda x: torch.cat([x, x.new_zeros((chunk - m,) + x.shape[1:])], dim=0), piece)
            out = self.model.get_nff_outputs(piece, chunk if all_camera else 0, edits=edits)
            outs.append({k: v[:m] for k, v in out.items()})
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

    # ------------------------------------------------------------------
    # evaluation renders
    # ------------------------------------------------------------------

    @torch.no_grad()
    def render_eval_camera(self, cam_idx: int, edits: Optional[ActorEdits] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Full-image render -> (pred rgb [H', W', 3], gt rgb). `edits`: actor
        edits applied at render time."""
        bundle, gt, (hs, ws) = self.datamanager.eval_camera_bundle(cam_idx)
        nff = self._chunked_nff(bundle, all_camera=True, edits=edits)
        rgb = self.model.decode_features(nff["features"], (hs, ws), hs * ws)[0]
        return rgb[0].cpu().numpy(), gt

    @torch.no_grad()
    def render_eval_lidar(self, scan_idx: int) -> Dict[str, np.ndarray]:
        bundle, pts = self.datamanager.eval_lidar_bundle(scan_idx)
        nff = self._chunked_nff(bundle, all_camera=False)
        _, intensity, ray_drop = self.model.decode_features(nff["features"], (1, 1), 0)
        host = lambda x: x.cpu().numpy()
        return {
            "depth": host(nff["depth"]),
            "intensity": host(intensity),
            "ray_drop_logits": host(ray_drop),
            "gt_distance": host(bundle.metadata["directions_norm"]),
            "gt_intensity": pts[:, 3:4],
            "did_return": host(bundle.metadata["did_return"]),
            "origins": host(bundle.origins),
            "directions": host(bundle.directions),
        }

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
