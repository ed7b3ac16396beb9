"""SplatAD: 3D gaussian splatting for AD scenes, camera + lidar rendering and
their losses (torch port of `neurad_tpu/models/splatad.py`).

Gaussian parameters are fixed-capacity tensors [cap, ...]. Actor gaussians
store means in their box frame with a per-gaussian actor id; the world
transform and per-gaussian velocity (v + w x r) are computed densely. The
renders are differentiable in every parameter (the tile composites through
their backward kernels); densification lives in `model_components/strategy.py`
and the train steps in `pipelines/splatad_pipeline.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from neurad_tpu_torch.cameras.camera_optimizers import CameraOptimizer, CameraVelocityOptimizer
from neurad_tpu_torch.fields.mlp import MLP
from neurad_tpu_torch.model_components import losses as L
from neurad_tpu_torch.model_components.cnns import BasicBlock
from neurad_tpu_torch.model_components.dynamic_actors import ActorData, DynamicActors
from neurad_tpu_torch.ops import gaussian_rasterize as GR
from neurad_tpu_torch.ops import gaussians as G

BACKGROUND = (0.1490, 0.1647, 0.2157)


class RGBDecoderCNN(nn.Module):
    """View-dependent RGB decoder: rendered features split into albedo (first
    `skip_dim`) + specular; net(spec, ray_dirs) -> (gain, offset);
    rgb = albedo * (1 + gain) + offset. NHWC in and out."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int = 32,
        kernel_size: int = 3,
        num_hidden_blocks: int = 1,
        skip_dim: int = 3,
        compute_dtype=torch.bfloat16,
    ):
        super().__init__()
        self.skip_dim = skip_dim
        spec_dim = in_dim - skip_dim + 3
        self.blocks = nn.ModuleList(
            [BasicBlock(spec_dim, hidden_dim, kernel_size, norm="none", compute_dtype=compute_dtype)]
            + [
                BasicBlock(hidden_dim, hidden_dim, kernel_size, norm="none", compute_dtype=compute_dtype)
                for _ in range(num_hidden_blocks)
            ]
        )
        self.head = nn.Conv2d(hidden_dim, 6, 1)  # fp32

    def forward(self, features: torch.Tensor, ray_dirs: torch.Tensor) -> torch.Tensor:
        """features [H, W, F], ray_dirs [H, W, 3] -> rgb [H, W, 3]."""
        albedo = features[..., : self.skip_dim]
        h = torch.cat([features[..., self.skip_dim :], ray_dirs], dim=-1)[None]
        for block in self.blocks:
            h = block(h)
        out = self.head(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)[0]
        return albedo * (1.0 + out[..., :3]) + out[..., 3:]


def actor_adjusted_means(
    means: torch.Tensor,  # [N, 3] (box frame for actor gaussians)
    ids: torch.Tensor,  # [N] int, id == n_actors marks static
    n_actors: int,
    b2w: torch.Tensor,  # [A, 4, 4]
    vels6: torch.Tensor,  # [A, 6] (linear world, angular box frame)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame means + velocities for all gaussians. The angular
    contribution is rot(ang) x rot(r_box).

    Each gaussian's pose and velocity are selected with a one-hot [N, A]
    product, as in the JAX package, not with `b2w[ids]`: the backward of that
    gather scatters N rows into A, and with a handful of actors every row
    collides (PyTorch's indexing backward took 220 ms of a 290 ms train step
    at 500,000 gaussians on an H100). As a product the backward is
    onehot^T @ cotangent. fp32 products on CUDA run in full fp32 unless TF32
    is switched on, so the selection is exact."""
    ids_c = ids.long().clamp(0, n_actors - 1)
    is_actor = (ids < n_actors)[:, None]
    onehot = torch.nn.functional.one_hot(ids_c, n_actors).to(means.dtype)  # [N, A]
    pose = (onehot @ b2w.reshape(n_actors, 16)).reshape(-1, 4, 4)
    rot = pose[:, :3, :3]
    r_world = torch.einsum("nij,nj->ni", rot, means)  # offset from box centre, world frame
    world_means = r_world + pose[:, :3, 3]
    vel6 = onehot @ vels6
    ang_world = torch.einsum("nij,nj->ni", rot, vel6[:, 3:])
    vel = vel6[:, :3] + torch.linalg.cross(ang_world, r_world, dim=-1)
    return torch.where(is_actor, world_means, means), torch.where(is_actor, vel, torch.zeros_like(vel))


def viewmat_from_c2w_opengl(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL camera-to-world [3|4, 4] -> OpenCV world-to-camera 4x4."""
    flip = torch.diag(c2w.new_tensor([1.0, -1.0, -1.0]))
    r_wc = (c2w[:3, :3] @ flip).T
    view = torch.eye(4, dtype=c2w.dtype, device=c2w.device)
    view[:3, :3] = r_wc
    view[:3, 3] = -r_wc @ c2w[:3, 3]
    return view


def ray_dirs_pinhole(K: torch.Tensor, width: int, height: int, c2w: torch.Tensor) -> torch.Tensor:
    """Unit view dirs per pixel [H, W, 3]."""
    dev = K.device
    ys, xs = torch.meshgrid(
        torch.arange(height, device=dev) + 0.5, torch.arange(width, device=dev) + 0.5, indexing="ij"
    )
    d = torch.stack([(xs - K[0, 2]) / K[0, 0], -(ys - K[1, 2]) / K[1, 1], -torch.ones_like(xs)], dim=-1)
    d = d @ c2w[:3, :3].T
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


class GaussianInit(NamedTuple):
    """Host-side seed arrays used to initialise the gaussian parameters."""

    means: np.ndarray  # [cap, 3] (box frame for actor gaussians)
    scales_log: np.ndarray  # [cap, 3]
    quats: np.ndarray  # [cap, 4] wxyz
    features: np.ndarray  # [cap, feature_dim]
    opacities_logit: np.ndarray  # [cap]
    ids: np.ndarray  # [cap] int (n_actors = static)


def seed_gaussians(
    points: np.ndarray,
    trajectories,
    cap_max: int,
    feature_dim: int = 16,
    n_far_points: int = 30000,
    scene_aabb: Optional[np.ndarray] = None,
    init_opacity: float = 0.1,
    seed: int = 0,
) -> GaussianInit:
    """Seed from lidar points split static/dynamic by actor boxes + far/in-box
    random points, padded/subsampled to cap_max (numpy; the same seed gives the
    JAX package's arrays).

    points: [N, >=4] world xyz + intensity (+ rgb at cols 4:7 and per-point
    time at col 7). Each point is tested against the actor box posed at the
    point's timestamp; symmetric actors get their in-box points mirrored across
    the box x-axis.
    """
    rng = np.random.default_rng(seed)
    n_actors = len(trajectories)

    has_rgb = points.shape[1] >= 7
    has_time = points.shape[1] >= 8
    pt_time = points[:, 7] if has_time else np.zeros(points.shape[0], np.float32)

    ids = np.full(points.shape[0], n_actors, dtype=np.int32)
    means = points[:, :3].astype(np.float32).copy()
    mirror_rows = []
    for a, traj in enumerate(trajectories):
        poses = np.asarray(traj["poses"])  # [T, 4, 4] box2world
        ts = np.asarray(traj.get("timestamps", np.zeros(poses.shape[0])))
        half = np.asarray(traj["dims"]) / 2.0 + 0.25
        ti = np.abs(pt_time[:, None] - ts[None, :]).argmin(-1) if len(ts) > 1 else np.zeros(
            points.shape[0], np.int64
        )
        w2b = np.linalg.inv(poses)
        rot = w2b[ti, :3, :3]
        tr = w2b[ti, :3, 3]
        local = np.einsum("nij,nj->ni", rot, points[:, :3]) + tr
        inside = (np.abs(local) < half).all(-1)
        ids[inside] = a
        means[inside] = local[inside].astype(np.float32)
        if bool(traj.get("symmetric", False)) and inside.any():
            mirrored = local[inside].astype(np.float32).copy()
            mirrored[:, 0] *= -1.0
            mirror_rows.append((mirrored, a, points[inside]))

    if mirror_rows:
        m_means = np.concatenate([m for m, _, _ in mirror_rows])
        m_ids = np.concatenate([np.full(m.shape[0], a, np.int32) for m, a, _ in mirror_rows])
        m_src = np.concatenate([src_pts for _, _, src_pts in mirror_rows])
        means = np.concatenate([means, m_means])
        ids = np.concatenate([ids, m_ids])
        points = np.concatenate([points, m_src])

    # far points on an inverse-depth distribution + in-box randoms
    if scene_aabb is None:
        scene_aabb = np.array([[-80, -80, -10], [80, 80, 30]], dtype=np.float32)
    extent = scene_aabb[1] - scene_aabb[0]
    dirs = rng.normal(size=(n_far_points, 3))
    dirs[:, 2] = np.abs(dirs[:, 2])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    near = min(extent[0], extent[1]) / 2
    u = rng.uniform(size=(n_far_points, 1))
    dist = 1.0 / (1.0 / near * (1 - u) + 1.0 / 1e4 * u)
    far_pts = (dirs * dist).astype(np.float32)
    close_pts = ((rng.uniform(size=(n_far_points, 3)) - 0.5) * np.array([extent[0], extent[1], 50])).astype(
        np.float32
    )
    extra = np.concatenate([far_pts, close_pts])
    means = np.concatenate([means, extra])
    ids = np.concatenate([ids, np.full(extra.shape[0], n_actors, dtype=np.int32)])
    intensity = np.concatenate(
        [points[:, 3] if points.shape[1] > 3 else np.full(points.shape[0], 0.5), rng.uniform(size=extra.shape[0])]
    )
    rgb = np.concatenate([points[:, 4:7], rng.uniform(size=(extra.shape[0], 3))]).astype(np.float32) if has_rgb else None

    n = means.shape[0]
    if n >= cap_max:
        sel = rng.choice(n, size=cap_max, replace=False)
    else:
        sel = np.concatenate([np.arange(n), rng.integers(0, n, size=cap_max - n)])
    means, ids, intensity = means[sel], ids[sel], intensity[sel]
    if rgb is not None:
        rgb = rgb[sel]

    scales = np.full((cap_max, 3), np.log(0.3), dtype=np.float32)
    feats = np.zeros((cap_max, feature_dim), dtype=np.float32)
    if rgb is not None:
        feats[:, :3] = rgb  # painted camera colours seed the first channels
    else:
        feats[:, :3] = intensity[:, None]  # gray init from intensity
    quats = np.zeros((cap_max, 4), dtype=np.float32)
    quats[:, 0] = 1.0
    op = np.full(cap_max, np.log(init_opacity / (1 - init_opacity)), dtype=np.float32)
    return GaussianInit(
        means=means.astype(np.float32),
        scales_log=scales,
        quats=quats,
        features=feats,
        opacities_logit=op,
        ids=ids,
    )


@dataclasses.dataclass(frozen=True)
class SplatADConfig:
    """Model settings (the JAX package's `SplatADConfig`, same fields)."""

    feature_dim: int = 16
    appearance_dim: int = 8
    rgb_decoder_hidden_dim: int = 32
    rgb_decoder_kernel_size: int = 3
    rgb_decoder_num_hidden_blocks: int = 1
    tile_size: int = 16
    num_downscales: int = 2
    resolution_schedule: int = 3000
    max_per_tile: int = 256
    max_tiles_per_gaussian: int = 16
    max_visible_gaussians: int = 0
    near_plane: float = 0.5
    radius_clip_pix: float = 0.0
    eps2d: float = 0.3
    antialiased: bool = True
    ssim_lambda: float = 0.2
    depth_lambda: float = 0.1
    intensity_lambda: float = 1.0
    ray_drop_lambda: float = 0.1
    line_of_sight_lambda: float = 0.1
    depth_loss_quantile_threshold: float = 0.95
    mcmc_scale_reg_lambda: float = 0.01
    mcmc_opacity_reg_lambda: float = 0.01
    compensate_rs_camera: bool = True
    lidar_elev_range: Tuple[float, float] = (-26.0, 16.0)
    lidar_tile_azim: float = 2.0
    lidar_tile_elev: float = 2.0
    lidar_max_per_tile: int = 128
    # only "tiled" is ported; the per-point "points" path waits
    lidar_raster_mode: str = "tiled"
    lidar_pts_per_tile: int = 128
    # the port's compositor is the fp32 Pallas composite ("pallas"); "hybrid"
    # and "xla" (XLA's bf16 composite, a TPU trade-off) raise on every device
    rasterize_backend: str = "pallas"


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


class SplatADModel(nn.Module):
    """The SplatAD model: fixed-capacity gaussian parameters, actor
    trajectories, camera optimizers, the RGB CNN and lidar MLP decoders, and a
    per-sensor appearance embedding. Initialised from `init_data` with the
    port's own initialisers (`generator` makes them reproducible)."""

    def __init__(
        self,
        init_data: GaussianInit,
        actor_data: ActorData,
        config: SplatADConfig = SplatADConfig(),
        num_sensors: int = 1,
        num_train_images: int = 1,
        camera_opt_mode: str = "off",
        velocity_opt_enabled: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if config.lidar_raster_mode != "tiled":
            raise NotImplementedError("only lidar_raster_mode='tiled' is ported")
        self.config = config
        self.init_data = init_data
        self.actor_data = actor_data
        self.velocity_opt_enabled = velocity_opt_enabled
        self.means = nn.Parameter(torch.from_numpy(np.asarray(init_data.means, np.float32)).clone())
        self.scales = nn.Parameter(torch.from_numpy(np.asarray(init_data.scales_log, np.float32)).clone())
        self.quats = nn.Parameter(torch.from_numpy(np.asarray(init_data.quats, np.float32)).clone())
        self.features = nn.Parameter(torch.from_numpy(np.asarray(init_data.features, np.float32)).clone())
        self.opacities = nn.Parameter(torch.from_numpy(np.asarray(init_data.opacities_logit, np.float32)).clone())
        self.register_buffer(
            "gauss_ids", torch.from_numpy(np.asarray(init_data.ids, np.int32)).clone(), persistent=False
        )

        self.actors = DynamicActors(actor_data)
        self.camera_optimizer = CameraOptimizer(num_train_images, mode=camera_opt_mode)
        self.camera_velocity_optimizer = CameraVelocityOptimizer(
            num_train_images, num_sensors, enabled=velocity_opt_enabled
        )
        self.rgb_decoder = RGBDecoderCNN(
            config.feature_dim + config.appearance_dim,
            hidden_dim=config.rgb_decoder_hidden_dim,
            kernel_size=config.rgb_decoder_kernel_size,
            num_hidden_blocks=config.rgb_decoder_num_hidden_blocks,
        )
        self.lidar_decoder = MLP(
            config.feature_dim + config.appearance_dim + 3, out_dim=2, num_layers=3, layer_width=32
        )
        self.appearance_embedding = nn.Embedding(num_sensors, config.appearance_dim)
        self._init_decoders(generator)

    @torch.no_grad()
    def _init_decoders(self, generator: Optional[torch.Generator]) -> None:
        """The JAX package's initialiser families (lecun-normal kernels, zero
        biases, a 1e-4-scaled head, unit-variance-over-fan-in embeddings),
        drawn from torch's generator: same distributions, not the same values."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                scale = 1e-4 if module is self.rgb_decoder.head else 1.0
                std = math.sqrt(scale / fan_in) / 0.87962566103423978  # truncated-normal correction
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                nn.init.zeros_(module.bias)
        emb = self.appearance_embedding.weight
        emb.normal_(0.0, 1.0 / math.sqrt(emb.shape[1]), generator=generator)

    @property
    def n_actors(self) -> int:
        return self.actor_data.n_actors

    @property
    def device(self) -> torch.device:
        return self.means.device

    def _actor_adjusted_means(self, time: torch.Tensor, edits=None):
        if self.n_actors == 0:
            return self.means, torch.zeros_like(self.means)
        b2w, _ = self.actors.get_boxes2world(time.reshape(1), edits=edits)  # [1, A, 4, 4]
        vels6 = self.actors.get_velocities(time.reshape(1))[0]  # [A, 6]
        return actor_adjusted_means(self.means, self.gauss_ids, self.n_actors, b2w[0], vels6)

    def get_camera_outputs(
        self,
        c2w_opengl,  # [3, 4]
        K,  # [3, 3]
        width: int,
        height: int,
        time,  # []
        sensor_idx,  # [] int
        cam_idx,  # [] int (per-image index, for the optimizers)
        cam_linear_vel=None,  # [3] world frame
        cam_angular_vel=None,  # [3] local frame
        rolling_shutter_time: float = 0.0,
        time_to_center_pixel: float = 0.0,
        means2d_offset: Optional[torch.Tensor] = None,
        edits=None,
    ) -> Dict[str, torch.Tensor]:
        """Camera render. Array arguments may be numpy or tensors; they move to
        the model's device. means2d_offset: zeros [N, 2] whose gradient equals
        d(loss)/d(means2d), the signal the Default densification strategy reads."""
        cfg = self.config
        dev = self.device
        c2w_opengl, K = _as_tensor(c2w_opengl, dev), _as_tensor(K, dev)
        time = _as_tensor(time, dev)
        sensor_idx = _as_tensor(sensor_idx, dev, torch.long)
        cam_idx = _as_tensor(cam_idx, dev, torch.long)
        c2w = self.camera_optimizer.apply_to_camera_pose(c2w_opengl[None], cam_idx)[0]

        lin_vel = _as_tensor(cam_linear_vel, dev) if cam_linear_vel is not None else torch.zeros(3, device=dev)
        ang_vel = _as_tensor(cam_angular_vel, dev) if cam_angular_vel is not None else torch.zeros(3, device=dev)
        time_to_center_pixel = _as_tensor(time_to_center_pixel, dev)
        if self.velocity_opt_enabled:
            lin_vel = self.camera_velocity_optimizer.get_linear_velocity(lin_vel[None], cam_idx.reshape(1))[0]
            ang_vel = self.camera_velocity_optimizer.get_angular_velocity(ang_vel[None], cam_idx.reshape(1))[0]
            time_to_center_pixel = (
                time_to_center_pixel
                + self.camera_velocity_optimizer.get_time_to_center_pixel_adjustment(sensor_idx.reshape(1))[0]
            )
        c2w = c2w.clone()
        c2w[:3, 3] = c2w[:3, 3] + lin_vel * time_to_center_pixel
        cam_time = time + time_to_center_pixel

        viewmat = viewmat_from_c2w_opengl(c2w)
        flip = c2w.new_tensor([1.0, -1.0, -1.0])
        lin_vel_cam = (c2w[:3, :3].T @ lin_vel) * flip
        ang_vel_cam = ang_vel * flip

        means, vels = self._actor_adjusted_means(cam_time, edits)
        covar6 = G.quat_scale_to_covar6(self.quats, torch.exp(self.scales))
        proj = G.project_gaussians_camera(
            means,
            covar6=covar6,
            viewmat=viewmat,
            K=K,
            width=width,
            height=height,
            velocities=vels,
            camera_linear_velocity=lin_vel_cam,
            camera_angular_velocity=ang_vel_cam,
            near_plane=cfg.near_plane,
            eps2d=cfg.eps2d,
            radius_clip=cfg.radius_clip_pix,
            antialiased=cfg.antialiased,
        )
        if means2d_offset is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_offset)
        feat_img, depth_img, alpha_img, binning = GR.rasterize_camera(
            proj,
            self.features,
            torch.sigmoid(self.opacities),
            width,
            height,
            tile_size=cfg.tile_size,
            max_per_tile=cfg.max_per_tile,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            rolling_shutter_time=rolling_shutter_time,
            backend=cfg.rasterize_backend,
            return_binning=True,
            max_visible=cfg.max_visible_gaussians,
        )

        ray_dirs = ray_dirs_pinhole(K, width, height, c2w)
        appearance = self.appearance_embedding(sensor_idx.reshape(1))[0]
        app_img = appearance.expand(feat_img.shape[:-1] + (appearance.shape[-1],))
        rgb = self.rgb_decoder(torch.cat([feat_img, app_img], dim=-1), ray_dirs)
        background = rgb.new_tensor(BACKGROUND)
        rgb = torch.clamp(rgb + (1.0 - alpha_img) * background, 0.0, 1.0)
        depth_img = torch.where(alpha_img > 0, depth_img, depth_img.detach().max())
        return {
            "rgb": rgb,
            "depth": depth_img,
            "accumulation": alpha_img,
            "background": background,
            "radii": proj.radii.detach(),
            "binning_dropped_pairs": binning.dropped_pairs,
            "binning_cropped_gaussians": binning.cropped_gaussians,
            "binning_culled_visible": binning.culled_visible,
        }

    def get_lidar_outputs(
        self,
        l2w,  # [3, 4]
        raster_pts,  # [M, 5] (azim, elev, depth, time, intensity)
        time,
        sensor_idx,
        lidar_linear_vel=None,
        lidar_angular_vel=None,
        edits=None,
    ) -> Dict[str, torch.Tensor]:
        """Lidar render at spherical query points."""
        cfg = self.config
        dev = self.device
        l2w, raster_pts = _as_tensor(l2w, dev), _as_tensor(raster_pts, dev)
        time, sensor_idx = _as_tensor(time, dev), _as_tensor(sensor_idx, dev, torch.long)
        means, vels = self._actor_adjusted_means(time, edits)
        covar6 = G.quat_scale_to_covar6(self.quats, torch.exp(self.scales))
        r_wl = l2w[:3, :3].T
        viewmat = torch.eye(4, device=dev)
        viewmat[:3, :3] = r_wl
        viewmat[:3, 3] = -r_wl @ l2w[:3, 3]
        lin_v = _as_tensor(lidar_linear_vel, dev) if lidar_linear_vel is not None else torch.zeros(3, device=dev)
        lin = l2w[:3, :3].T @ lin_v
        ang = _as_tensor(lidar_angular_vel, dev) if lidar_angular_vel is not None else torch.zeros(3, device=dev)
        proj = G.project_gaussians_lidar(
            means, covar6=covar6, viewmat=viewmat, velocities=vels,
            lidar_linear_velocity=lin, lidar_angular_velocity=ang,
        )
        out = GR.rasterize_lidar_points_tiled(
            proj, self.features, torch.sigmoid(self.opacities), raster_pts[:, :4],
            elev_range=cfg.lidar_elev_range,
            tile_size_azim=cfg.lidar_tile_azim,
            tile_size_elev=cfg.lidar_tile_elev,
            max_per_tile=cfg.lidar_max_per_tile,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            pts_per_tile=cfg.lidar_pts_per_tile,
            backend=cfg.rasterize_backend,
        )
        azim = torch.deg2rad(raster_pts[:, 0])
        elev = torch.deg2rad(raster_pts[:, 1])
        dirs = torch.stack(
            [torch.cos(elev) * torch.cos(azim), torch.cos(elev) * torch.sin(azim), torch.sin(elev)], dim=-1
        )
        dirs = dirs @ l2w[:3, :3].T  # the decoder takes world-frame ray dirs
        appearance = self.appearance_embedding(sensor_idx.reshape(1))[0].expand(dirs.shape[0], -1)
        dec = self.lidar_decoder(torch.cat([out["features"], appearance, dirs], dim=-1))
        out["intensity"] = torch.sigmoid(dec[..., :1])
        out["ray_drop_logits"] = dec[..., 1:]
        return out

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------

    def camera_loss(self, outputs: Dict[str, torch.Tensor], gt_image) -> Tuple[torch.Tensor, Dict]:
        cfg = self.config
        pred = outputs["rgb"]
        gt_image = _as_tensor(gt_image, pred.device)
        l1 = torch.mean(torch.abs(gt_image - pred))
        ssim_val = L.ssim(pred, gt_image)
        main = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * (1.0 - ssim_val)
        reg = self._mcmc_regs()
        metrics = {
            "main_loss": main,
            "psnr": L.psnr(pred.detach(), gt_image),
            "ssim": ssim_val.detach(),
            **reg,
        }
        total = main + reg["mcmc_scale_reg"] + reg["mcmc_opacity_reg"] + self.camera_optimizer.regularization_loss()
        total = total + self.camera_velocity_optimizer.regularization_loss()
        for k in ("binning_dropped_pairs", "binning_cropped_gaussians"):
            if k in outputs:
                metrics[k] = outputs[k]
        return total, metrics

    def lidar_loss(self, outputs: Dict[str, torch.Tensor], raster_pts, did_return, valid) -> Tuple[torch.Tensor, Dict]:
        """raster_pts [M, 5]; did_return / valid [M] bools."""
        cfg = self.config
        dev = outputs["depth"].device
        raster_pts = _as_tensor(raster_pts, dev)
        did_return = _as_tensor(did_return, dev, torch.bool)
        valid = _as_tensor(valid, dev, torch.bool)
        ret = valid & did_return
        depth = outputs["depth"][:, 0]
        gt_depth = raster_pts[:, 2]
        unred = torch.abs(depth - gt_depth)
        quantile = L.masked_quantile(unred, ret, cfg.depth_loss_quantile_threshold)
        qmask = ret & (unred < quantile)

        depth_loss = cfg.depth_lambda * L.masked_mean(unred, qmask)
        intensity = outputs["intensity"][:, 0]
        intensity_loss = cfg.intensity_lambda * L.masked_mean((intensity - raster_pts[:, 4]) ** 2, qmask)

        logits = outputs["ray_drop_logits"][:, 0]
        targets = (~did_return).to(logits.dtype)
        bce = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
        # padded points (valid=False) carry did_return=False: masked out and
        # left out of the count
        ray_drop_loss = cfg.ray_drop_lambda * L.masked_mean(bce, valid)

        los = cfg.line_of_sight_lambda * L.masked_mean(outputs["alpha_sum_until_points"][:, 0], qmask)

        reg = self._mcmc_regs()
        total = depth_loss + intensity_loss + ray_drop_loss + los + reg["mcmc_scale_reg"] + reg["mcmc_opacity_reg"]
        rel = ((depth - gt_depth) / gt_depth.clamp_min(1e-6)) ** 2
        metrics = {
            "depth_loss": depth_loss,
            "intensity_loss": intensity_loss,
            "ray_drop_loss": ray_drop_loss,
            "line_of_sight_loss": los,
            "depth_median_l2": L.masked_quantile((depth - gt_depth) ** 2, ret, 0.5),
            "depth_mean_rel_l2": L.masked_mean(rel, ret),
            "ray_drop_accuracy": L.masked_mean(((torch.sigmoid(logits) > 0.5) == ~did_return).float(), valid),
            **reg,
        }
        for k in ("binning_dropped_pairs", "binning_cropped_gaussians", "points_overflowed"):
            if k in outputs:
                metrics[k] = outputs[k]
        return total, metrics

    def _mcmc_regs(self) -> Dict[str, torch.Tensor]:
        cfg = self.config
        return {
            "mcmc_scale_reg": cfg.mcmc_scale_reg_lambda * torch.abs(torch.exp(self.scales).mean()),
            "mcmc_opacity_reg": cfg.mcmc_opacity_reg_lambda * torch.abs(torch.sigmoid(self.opacities).mean()),
        }
