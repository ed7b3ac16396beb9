"""Splatfacto training pipeline (torch port of
`neurad_tpu/pipelines/splatfacto_pipeline.py`): camera-only 3DGS over a parsed
dataset's train cameras, with Default-strategy densification (grow / split /
prune) at a fixed capacity.

The gaussians are allocated once at `capacity`; dead slots are encoded in the
parameters themselves (`model_components/strategy.py`), so refines change no
shape. The model owns the parameters; `init_state` makes the rest of the
training state (one Adam per parameter, the step, the generator the refines
draw from). `train_step` draws a train camera with numpy's generator seeded as
the JAX pipeline's, renders it, takes one update and refines when the strategy
says so; the absgrad signal is the gradient of a zeros `means2d_offset`. The
batched and mesh-sharded steps of the JAX pipeline are not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.data.dataparsers.base import ADDataparserOutputs
from neurad_tpu_torch.engine.optimizers import OptimizerGroupConfig, Optimizers
from neurad_tpu_torch.model_components import losses as L
from neurad_tpu_torch.model_components.strategy import (
    DEAD_OPACITY,
    DEAD_SCALE,
    DefaultStrategyConfig,
    alive_mask,
    default_refine,
    reset_opacities,
    should_refine_default,
)
from neurad_tpu_torch.models.splatfacto import PARAM_KEYS, SplatfactoConfig, SplatfactoModel, random_init_gaussians

CHECKPOINT_PATTERN = "step-*.pt"
STATIC_ID = 10**6  # every gaussian is static: an id beyond any actor's


@dataclasses.dataclass
class SplatfactoPipelineConfig:
    model: SplatfactoConfig = dataclasses.field(default_factory=SplatfactoConfig)
    strategy: DefaultStrategyConfig = dataclasses.field(default_factory=DefaultStrategyConfig)
    capacity: int = 100_000
    num_init: int = 30_000
    seed: int = 0
    # per-group learning rates (Adam, eps 1e-15, constant); the means' is scaled by the scene's extent
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_sh_dc: float = 2.5e-3
    lr_sh_rest: float = 1.25e-4
    lr_opacities: float = 5e-2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SplatfactoPipelineConfig":
        model = dict(d["model"])
        model["background_color"] = tuple(model["background_color"])
        rest = {k: v for k, v in d.items() if k not in ("model", "strategy")}
        return cls(model=SplatfactoConfig(**model), strategy=DefaultStrategyConfig(**d["strategy"]), **rest)


@dataclasses.dataclass
class TrainState:
    """What training carries besides the model's parameters."""

    step: int
    optimizers: Optimizers
    generator: torch.Generator  # the refines' draws


def _pad_dead(params: Dict[str, np.ndarray], capacity: int) -> Dict[str, np.ndarray]:
    """Grow the arrays to `capacity`, the padding marked as dead slots."""
    n = params["means"].shape[0]
    pad = capacity - n
    if pad <= 0:
        return params
    out = {}
    for k, v in params.items():
        fill = np.zeros((pad,) + v.shape[1:], v.dtype)
        if k == "scales":
            fill[:] = DEAD_SCALE
        elif k == "opacities":
            fill[:] = DEAD_OPACITY
        elif k == "quats":
            fill[:, 0] = 1.0
        out[k] = np.concatenate([v, fill], axis=0)
    return out


class SplatfactoPipeline:
    """Camera-only splatting over a parsed dataset's train cameras."""

    def __init__(self, outputs: ADDataparserOutputs, config: Optional[SplatfactoPipelineConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config or SplatfactoPipelineConfig()
        self.outputs = outputs
        cfg = self.config
        self.scene_scale = float(outputs.scene_box.aabb.abs().max())
        init = random_init_gaussians(cfg.num_init, extent=self.scene_scale, seed=cfg.seed,
                                     sh_degree=cfg.model.sh_degree)
        self.model = SplatfactoModel(_pad_dead(init, cfg.capacity), cfg.model).to(self.device)
        ev = set(outputs.eval_camera_indices)
        self.train_indices = [i for i in range(len(outputs.images)) if i not in ev] or [0]
        self._order = np.random.default_rng(cfg.seed)
        self._grad2d_sum = torch.zeros(cfg.capacity, device=self.device)
        self._count = torch.zeros(cfg.capacity, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------

    def _camera(self, idx: int) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
        """(c2w [4, 4] OpenGL, K [3, 3], image [H, W, 3] in [0, 1] on the device)."""
        cams = self.outputs.cameras
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3] = cams.camera_to_worlds[idx].numpy()
        fx, fy, cx, cy = (float(getattr(cams, k)[idx, 0]) for k in ("fx", "fy", "cx", "cy"))
        K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=np.float32)
        img = np.asarray(self.outputs.images[idx], dtype=np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        return c2w, K, torch.as_tensor(img, device=self.device)

    def rng_state(self) -> dict:
        """The camera sampler's state, saved with a checkpoint for an exact resume."""
        return self._order.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._order.bit_generator.state = state

    def _lrs(self) -> Dict[str, float]:
        cfg = self.config
        return {"means": cfg.lr_means * self.scene_scale, "scales": cfg.lr_scales, "quats": cfg.lr_quats,
                "sh_dc": cfg.lr_sh_dc, "sh_rest": cfg.lr_sh_rest, "opacities": cfg.lr_opacities}

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.config.seed if seed is None else seed)
        groups = {k: OptimizerGroupConfig(lr=lr) for k, lr in self._lrs().items()}
        optimizers = Optimizers(self.model.named_parameters(), groups, tuple((k, k) for k in PARAM_KEYS))
        return TrainState(step=0, optimizers=optimizers, generator=generator)

    def train_step(self, state: TrainState, cam_idx: Optional[int] = None) -> Tuple[TrainState, Dict]:
        """One update from a train camera (drawn when not given), the absgrad
        sums, then the refine and the opacity reset when they are due."""
        cfg = self.config
        if cam_idx is None:
            cam_idx = self.train_indices[int(self._order.integers(len(self.train_indices)))]
        c2w, K, img = self._camera(cam_idx)
        h, w = img.shape[:2]
        offset = torch.zeros((cfg.capacity, 2), device=self.device, requires_grad=True)
        out = self.model.render(c2w, K, w, h, means2d_offset=offset)
        total, metrics = self.model.loss(out, img)
        state.optimizers.zero_grad()
        total.backward()
        state.optimizers.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        # absgrad statistics: pixel-space gradients scaled by half the image's size, where the gaussian was visible
        g2d = torch.linalg.norm(offset.grad * offset.new_tensor([w / 2.0, h / 2.0]), dim=-1)
        visible = out["radii"] > 0
        self._grad2d_sum += torch.where(visible, g2d, torch.zeros_like(g2d))
        self._count += visible.to(torch.int32)

        if should_refine_default(state.step, cfg.strategy):
            self._refine(state)
        if state.step % cfg.strategy.reset_every == 0 and 0 < state.step < cfg.strategy.refine_stop_iter:
            self._set_gaussians(reset_opacities(self._gaussians(), cfg.strategy))
        return state, metrics

    def _gaussians(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self.model, k).detach() for k in PARAM_KEYS}

    @torch.no_grad()
    def _set_gaussians(self, gauss: Dict[str, torch.Tensor]) -> None:
        for k in PARAM_KEYS:
            getattr(self.model, k).copy_(gauss[k])

    def _refine(self, state: TrainState, split_eps=None) -> None:
        """Grow / split / prune from the running mean of the absgrad norms (the
        optimizer's moments left as they are, as in the JAX pipeline); the sums
        start anew. split_eps: explicit draws (see `default_refine`)."""
        gauss = self._gaussians()
        gauss["id"] = torch.full((self.config.capacity,), STATIC_ID, dtype=torch.int32, device=self.device)
        grad_avg = self._grad2d_sum / self._count.to(torch.float32).clamp_min(1.0)
        new_gauss, _ = default_refine(state.generator, gauss, grad_avg, self.config.strategy, self.scene_scale,
                                      step=state.step, split_eps=split_eps)
        self._set_gaussians(new_gauss)
        self._grad2d_sum.zero_()
        self._count.zero_()

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, state: TrainState, checkpoint_dir) -> Path:
        """Write `step-<step>.pt`: the model's state dict, the optimizers, the
        step, the generator's and the camera sampler's state and the absgrad sums."""
        checkpoint_dir = Path(checkpoint_dir)
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
        path = checkpoint_dir / f"step-{state.step:09d}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save({"step": state.step, "model": self.model.state_dict(),
                    "optimizers": state.optimizers.state_dict(), "generator": state.generator.get_state(),
                    "sampler_rng": self.rng_state(), "grad2d_sum": self._grad2d_sum, "count": self._count}, tmp)
        tmp.replace(path)
        return path

    @staticmethod
    def latest_checkpoint(checkpoint_dir) -> Path:
        found = sorted(Path(checkpoint_dir).glob(CHECKPOINT_PATTERN))
        if not found:
            raise FileNotFoundError(f"no checkpoint ({CHECKPOINT_PATTERN}) in {checkpoint_dir}")
        return found[-1]

    def load_checkpoint(self, checkpoint_dir, state: Optional[TrainState] = None) -> Optional[TrainState]:
        """Load the newest checkpoint into the model and, when a training state
        is given, into it and the camera sampler."""
        ckpt = torch.load(self.latest_checkpoint(checkpoint_dir), map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        if state is None:
            return None
        state.step = int(ckpt["step"])
        state.optimizers.load_state_dict(ckpt["optimizers"])
        state.generator.set_state(ckpt["generator"].cpu())
        self.set_rng_state(ckpt["sampler_rng"])
        self._grad2d_sum, self._count = ckpt["grad2d_sum"], ckpt["count"]
        return state

    # ------------------------------------------------------------------
    # renders and evaluation
    # ------------------------------------------------------------------

    def num_alive(self) -> int:
        return int(alive_mask(self._gaussians()).sum())

    @torch.inference_mode()
    def render_eval_camera(self, cam_idx: int, edits=None) -> Tuple[np.ndarray, np.ndarray]:
        """(pred rgb, gt rgb) of a camera, numpy (edits ignored: the scene is static)."""
        c2w, K, img = self._camera(cam_idx)
        out = self.model.render(c2w, K, img.shape[1], img.shape[0])
        return out["rgb"].cpu().numpy(), img.cpu().numpy()

    @torch.inference_mode()
    def render_viewer_image(self, c2w: np.ndarray, width: int, height: int, time: float = 0.0,
                            edits_vec=None) -> np.ndarray:
        """A render at an arbitrary pose, focal 0.7 * width (time and edits
        ignored: the scene is static)."""
        focal = 0.7 * width
        K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]], np.float32)
        return self.model.render(np.asarray(c2w, np.float32)[:3], K, width, height)["rgb"].cpu().numpy()

    @torch.inference_mode()
    def eval_psnr(self) -> float:
        vals = []
        for ci in self.outputs.eval_camera_indices:
            c2w, K, img = self._camera(ci)
            vals.append(float(L.psnr(self.model.render(c2w, K, img.shape[1], img.shape[0])["rgb"], img)))
        return float(np.mean(vals)) if vals else float("nan")

    @torch.inference_mode()
    def eval_metrics(self) -> Dict[str, float]:
        """PSNR and SSIM over the eval cameras, and the number of live gaussians."""
        psnrs, ssims = [], []
        for ci in self.outputs.eval_camera_indices:
            c2w, K, img = self._camera(ci)
            rgb = self.model.render(c2w, K, img.shape[1], img.shape[0])["rgb"]
            psnrs.append(float(L.psnr(rgb, img)))
            ssims.append(float(L.ssim(rgb, img)))
        if not psnrs:
            return {"num_gaussians": float(self.num_alive())}
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)), "num_gaussians": float(self.num_alive())}
