"""SplatAD's training step in plain PyTorch: one full camera frame or one full
lidar scan, its loss (L1 and SSIM of the frame; depth, intensity, ray drop and
line of sight of the scan; the MCMC opacity and scale regularisers), the
backward through the plain tile composites, Adam over the preset's groups
and, when the step lands on a refine, the MCMC relocation and its
exploration noise, computed by the frozen copy in `port/` from the
benchmark's scene and gaussians.

The reference follows the port step by step from two states recorded before
each step: that of the datamanager's sampler (`{"rng": numpy's generator
state, "raster_cache": the padded scans drawn so far}`), from which the frozen
full-image datamanager draws the step's frame or scan again, and that of the
port's step generator (torch), from which the relocation draws its targets
and its noise again (`step(..., draws=(targets, eps))` hands them over
instead). Training starts mid-schedule at the configuration's
`train.start_step`: the step count and every group's learning-rate schedule
stand there, Adam's moments at zero.

The composites' backward is autograd through their plain forward
(`port/ops/tile_composite.py`'s `tile_composite_*_plain`), not the frozen
copy of the hand-derived backward that the port's kernels follow: the
forward is kept, and the backward recomputes it one block of tiles at a time
under autograd (a full 1920x1080 frame's pairs of 256 slots and 256 pixels a
tile would not fit on the card at once), adding each block's gradient of the
packed table.

`precision` "stated": as the configuration states (the gaussians, the
projection, the composites and their backwards in fp32; the RGB decoder's
convolutions and the lidar decoder's MLP in bf16, the RGB head in fp32;
matmuls with TF32 off): the reference. One departure: cuDNN's TF32 flag is
left as PyTorch sets it (on), as the port runs and as `neurad_train.py`
leaves it, so the RGB head's fp32 1x1 convolution may run in TF32 on both
sides. "fp8": the control, one step below for each: the decoders on fp8
operands and the gaussians' parameters rounded to bf16 before the first step.
`fault = "half"`: the loss of the top half of the frame's rows, or of the
first half of the scan's valid points (the check's own planted fault).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from portbench.reference.common import set_precision
from portbench.reference.port.data.full_image_datamanager import (
    CameraSample,
    FullImageLidarDataManager,
    FullImageLidarDataManagerConfig,
)
from portbench.reference.port.engine.optimizers import OptimizerGroupConfig, Optimizers
from portbench.reference.port.model_components.dynamic_actors import actor_data_from_trajectories
from portbench.reference.port.model_components.strategy import (
    MCMCStrategyConfig,
    mcmc_add_noise,
    mcmc_relocate,
    should_refine,
)
from portbench.reference.port.models.splatad import GaussianInit, SplatADConfig, SplatADModel
from portbench.reference.port.ops import gaussian_rasterize as GR
from portbench.reference.port.ops import tile_composite as TC

GAUSSIAN_KEYS = ("means", "scales", "quats", "opacities", "features")
# the SplatAD pipeline's parameter groups (`pipelines/splatad_pipeline.py`), first match wins, "fields" otherwise
GROUP_RULES = (
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
CAMERA_BLOCK = 64  # tiles a recomputed block of the camera backward: 64 x 256 pixels x 256 slots
LIDAR_BLOCK = 128  # ... of the lidar backward: 128 x 128 points x 128 slots


def _blocked_grad(fn, table: torch.Tensor, t_total: int, block: int, grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The gradient of the packed table for the cotangents `grads` ([T, ...]
    each) of `fn(table, start, end)`'s outputs (those of tiles start..end),
    by autograd over `fn`, one block of tiles at a time."""
    leaf = table.detach().requires_grad_(True)
    with torch.enable_grad():
        for s in range(0, t_total, block):
            e = min(t_total, s + block)
            outs = fn(leaf, s, e)
            pairs = [(o, g[s:e]) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    return leaf.grad if leaf.grad is not None else torch.zeros_like(table)


class CameraComposite(torch.autograd.Function):
    """The camera tile composite's plain forward; its backward is autograd
    through that forward, recomputed a block of tiles at a time."""

    @staticmethod
    def forward(ctx, table, tile_gauss, tile_valid, pix, times):
        ctx.save_for_backward(table, tile_gauss, tile_valid, pix, times)
        return TC.tile_composite_camera_plain(table, tile_gauss, tile_valid, pix, times)

    @staticmethod
    def backward(ctx, g_feat, g_depth, g_alpha):
        table, tile_gauss, tile_valid, pix, times = ctx.saved_tensors

        def block(leaf, s, e):
            return TC.tile_composite_camera_plain(leaf, tile_gauss[s:e], tile_valid[s:e], pix[s:e], times[s:e],
                                                  tile_chunk=CAMERA_BLOCK)

        d_table = _blocked_grad(block, table, tile_gauss.shape[0], CAMERA_BLOCK, (g_feat, g_depth, g_alpha))
        return d_table, None, None, None, None


class LidarComposite(torch.autograd.Function):
    """The lidar tile composite's plain forward, the line-of-sight sum always
    computed (its cotangent enters the gradient, as in the port and the JAX
    package, whether or not the caller asked for it); the median carries no
    gradient. The backward as the camera's."""

    @staticmethod
    def forward(ctx, table, tile_gauss, tile_valid, pts_slot, vmask, wrap, depth_eps, compute_until):
        ctx.save_for_backward(table, tile_gauss, tile_valid, pts_slot, vmask)
        ctx.wrap, ctx.depth_eps = bool(wrap), float(depth_eps)
        feat, depth, acc, until, med = TC.tile_composite_lidar_plain(table, tile_gauss, tile_valid, pts_slot, vmask,
                                                                     wrap, depth_eps, True)
        ctx.mark_non_differentiable(med)
        return feat, depth, acc, until if compute_until else torch.zeros_like(until), med

    @staticmethod
    def backward(ctx, g_feat, g_depth, g_acc, g_until, _g_median):
        table, tile_gauss, tile_valid, pts_slot, vmask = ctx.saved_tensors

        def block(leaf, s, e):
            return TC.tile_composite_lidar_plain(leaf, tile_gauss[s:e], tile_valid[s:e], pts_slot[s:e], vmask[s:e],
                                                 ctx.wrap, ctx.depth_eps, True, tile_chunk=LIDAR_BLOCK)[:4]

        d_table = _blocked_grad(block, table, tile_gauss.shape[0], LIDAR_BLOCK, (g_feat, g_depth, g_acc, g_until))
        return d_table, None, None, None, None, None, None, None


@contextlib.contextmanager
def recomputed_composites():
    """The frozen rasterizer's composites replaced by `CameraComposite` and
    `LidarComposite` inside, and matmuls in full fp32 (TF32 off)."""
    old = (GR.tile_composite_camera, GR.tile_composite_lidar, torch.backends.cuda.matmul.allow_tf32)
    GR.tile_composite_camera = CameraComposite.apply
    GR.tile_composite_lidar = LidarComposite.apply
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        GR.tile_composite_camera, GR.tile_composite_lidar, torch.backends.cuda.matmul.allow_tf32 = old


def half_valid(valid: np.ndarray) -> np.ndarray:
    """`valid` with the second half of its valid points cleared."""
    out = np.array(valid, dtype=bool)
    idx = np.flatnonzero(out)
    out[idx[len(idx) // 2:]] = False
    return out


class SplatADTrain:
    def __init__(self, train: dict, scene, weights: Dict[str, torch.Tensor], gauss_ids: torch.Tensor, device,
                 precision: str = "stated"):
        self.device = torch.device(device)
        cap = int(weights["means"].shape[0])
        feature_dim = int(weights["features"].shape[1])
        init = GaussianInit(
            means=np.zeros((cap, 3), np.float32), scales_log=np.zeros((cap, 3), np.float32),
            quats=np.zeros((cap, 4), np.float32), features=np.zeros((cap, feature_dim), np.float32),
            opacities_logit=np.zeros((cap,), np.float32), ids=gauss_ids.cpu().numpy().astype(np.int32),
        )
        self.model = SplatADModel(
            init_data=init, actor_data=actor_data_from_trajectories(scene.trajectories),
            config=SplatADConfig(**train.get("model", {})), num_sensors=len(scene.sensor_idx_to_name),
            num_train_images=len(scene.images), generator=torch.Generator().manual_seed(0),
        ).to(self.device).eval()
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, w in weights.items():
                params[name].copy_(w)
            if precision == "fp8":
                for k in GAUSSIAN_KEYS:
                    params[k].copy_(params[k].to(torch.bfloat16).float())
        if precision != "stated":
            set_precision(self.model, precision)
        self.mcmc = MCMCStrategyConfig(**train.get("mcmc", {}))
        self.datamanager = FullImageLidarDataManager(
            scene, FullImageLidarDataManagerConfig(**train.get("datamanager", {})), seed=0)
        self.groups = {g: OptimizerGroupConfig(**v) for g, v in train["optimizer_groups"].items()}
        self.optimizers = Optimizers(self.model.named_parameters(), self.groups, GROUP_RULES)
        self.step_count = int(train.get("start_step", 0))
        # the schedules mid-schedule as a checkpoint of that step restores them (one update a window where a group
        # accumulates); Adam's state fresh
        opt = self.optimizers
        state = opt.state_dict()
        state.update(count=self.step_count,
                     updates={g: self.step_count // opt.configs[g].accum_steps for g in opt.params})
        opt.load_state_dict(state)
        self.initial = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.fault = ""  # "half": a planted fault, the loss of half the frame or scan (for the check's own test)

    def sample(self, sampler_state: dict):
        """The frame or scan that the port's datamanager drew from `sampler_state`."""
        dm = self.datamanager
        dm.set_rng_state(copy.deepcopy(sampler_state["rng"]))
        dm._raster_cache = dict(sampler_state["raster_cache"])
        return dm.next_train()

    def _downscale(self, s: CameraSample) -> CameraSample:
        """Coarse to fine: the image subsampled by 2^max(0, num_downscales -
        step // resolution_schedule)."""
        cfg = self.model.config
        if cfg.num_downscales <= 0 or cfg.resolution_schedule <= 0:
            return s
        d = 2 ** max(0, cfg.num_downscales - self.step_count // cfg.resolution_schedule)
        if d <= 1:
            return s
        img = s.image[::d, ::d]
        K = s.K.copy()
        K[:2] /= d
        return dataclasses.replace(s, image=img, K=K, width=img.shape[1], height=img.shape[0])

    def loss(self, s) -> torch.Tensor:
        model = self.model
        if isinstance(s, CameraSample):
            out = model.get_camera_outputs(
                s.c2w, s.K, s.width, s.height, s.time, s.sensor_idx, s.cam_idx, cam_linear_vel=s.linear_velocity,
                rolling_shutter_time=s.rolling_shutter_time, time_to_center_pixel=s.time_to_center_pixel)
            image = s.image
            if self.fault == "half":
                rows = s.height // 2
                out, image = dict(out, rgb=out["rgb"][:rows]), image[:rows]
            return model.camera_loss(out, image)[0]
        out = model.get_lidar_outputs(s.l2w, s.raster_pts, s.time, s.sensor_idx, lidar_linear_vel=s.linear_velocity)
        valid = half_valid(s.valid) if self.fault == "half" else s.valid
        return model.lidar_loss(out, s.raster_pts, s.did_return, valid)[0]

    def step(self, sampler_state: dict, generator_state: Optional[torch.Tensor] = None,
             draws: Optional[tuple] = None) -> float:
        """One update on the frame or scan drawn from `sampler_state`, then the
        relocation and noise where the step lands on a refine, drawn from the
        port's step generator in `generator_state` (or `draws`: (targets [N],
        eps [N, 3])) -> the step's loss."""
        s = self.sample(sampler_state)
        if isinstance(s, CameraSample):
            s = self._downscale(s)
        with recomputed_composites():
            self.model.train()
            try:
                total = self.loss(s)
                self.optimizers.zero_grad()
                total.backward()
            finally:
                self.model.eval()
        self.optimizers.step()
        self.step_count += 1
        if should_refine(self.step_count, self.mcmc):
            generator = None
            if draws is None:
                generator = torch.Generator(device=self.device)
                generator.set_state(generator_state)
            self.refine(generator, draws)
        return float(total.detach())

    @torch.no_grad()
    def refine(self, generator: Optional[torch.Generator], draws: Optional[tuple] = None) -> None:
        """MCMC relocation of the dead gaussians and the exploration noise on
        the means (the optimizer's moments left as they are)."""
        model = self.model
        gauss = {k: getattr(model, k).detach() for k in GAUSSIAN_KEYS}
        gauss["id"] = model.gauss_ids
        bounds = None
        if model.n_actors:
            sizes = torch.as_tensor(model.actor_data.sizes, dtype=torch.float32, device=self.device)
            bounds = sizes / 2.0 + sizes.new_tensor((0.25, 0.25, 0.1))
        targets, eps = draws if draws is not None else (None, None)
        new, _ = mcmc_relocate(generator, gauss, None, self.mcmc, bounds, model.n_actors, targets=targets)
        lr_means = self.groups["means"].schedule()(self.step_count)
        new = mcmc_add_noise(generator, new, lr_means, self.mcmc, eps=eps)
        for k in GAUSSIAN_KEYS:
            getattr(model, k).copy_(new[k])

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Each parameter's Adam first moment over (1 - beta1): after one step, its gradient."""
        out = {}
        names = {id(p): n for n, p in self.model.named_parameters()}
        for opt in self.optimizers.optimizers.values():
            for group in opt.param_groups:
                for p in group["params"]:
                    if "exp_avg" in opt.state[p]:
                        out[names[id(p)]] = opt.state[p]["exp_avg"] / (1.0 - group["betas"][0])
        return out

    def changes(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() - self.initial[n] for n, p in self.model.named_parameters()}
