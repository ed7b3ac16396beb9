"""NeuRAD's training step in plain PyTorch: the loss of a ray batch (the
feature-field render in chunks of `train_ray_chunk` rays, the decoders, every
loss term with the VGG19 perceptual loss), its backward through the plain
hash-grid lookup, and Adam over the configuration's parameter groups, computed
by the frozen copy in `port/` from the benchmark's scene and weights.

The reference follows the port step by step from two generator states
recorded before each step: that of the batch sampler (numpy), from which
`sample_batch` draws the step's camera patches and lidar points again and
builds their rays and targets from the benchmark's own scene, and that of the
port's step generator (torch), from which `draw` draws the step's jitters and
flips again (the pipeline's draw order).

`precision` "stated": the precision that the configuration states (its
model block's `compute_fp32`, and the backends' TF32 flags as the check
leaves them: PyTorch's defaults): the reference; or the control, one step
below (`common.set_precision`): "tf32" for an fp32 configuration, "fp8" for
a bf16 one. The VGG19 network computes as the configuration states in each.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference.common import precision_context, set_precision
from portbench.reference.port.cameras.cameras import generate_rays
from portbench.reference.port.cameras.lidars import generate_lidar_rays_from_points
from portbench.reference.port.core.structs import RayBundle, map_tensors
from portbench.reference.port.engine.optimizers import DEFAULT_GROUP_RULES, OptimizerGroupConfig, Optimizers
from portbench.reference.port.model_components.dynamic_actors import actor_data_from_trajectories
from portbench.reference.port.model_components.perceptual import load_vgg19_params
from portbench.reference.port.models.neurad import NeuRADModel

VGG_SEED = 1234  # the perceptual network's seed (a fixed random VGG19 unless pretrained weights are given)


class BatchSampler:
    """The training batch of a sampler state: `num_cam_patches` patches of
    `patch_size`^2 rays (one ray at the centre of each `rgb_upsample_factor`^2
    block of pixels) on training cameras, and `num_lidar_rays` points of
    training scans, drawn in the datamanager's order (cameras, first rows,
    first columns, points) from a numpy generator in that state, their rays
    generated from the scene's sensors and their targets read from its
    images and scans."""

    def __init__(self, train: dict, scene, device):
        self.scene, self.device = scene, torch.device(device)
        self.patches, self.d = int(train["num_cam_patches"]), int(train["patch_size"])
        self.up, self.n_lidar = int(train["rgb_upsample_factor"]), int(train["num_lidar_rays"])
        eval_cams = set(scene.eval_camera_indices)
        self.train_cams = np.array([i for i in range(len(scene.images)) if i not in eval_cams], dtype=np.int64)
        self.images = np.stack(scene.images)
        scans = [i for i in range(len(scene.point_clouds)) if i not in set(scene.eval_lidar_indices)]
        self.points = np.concatenate([scene.point_clouds[i] for i in scans])
        self.scan_ids = np.concatenate([np.full(scene.point_clouds[i].shape[0], i, np.int64) for i in scans])

    def __call__(self, state: dict):
        """-> (RayBundle [camera rays .. lidar rays], {image, distance, did_return, intensity})."""
        rng = np.random.default_rng()
        rng.bit_generator.state = state
        d, up, dev = self.d, self.up, self.device
        gt = d * up
        h, w = self.images.shape[1:3]
        cams = rng.choice(self.train_cams, size=self.patches)
        r0 = rng.integers(0, h - gt + 1, size=self.patches)
        c0 = rng.integers(0, w - gt + 1, size=self.patches)
        k = np.arange(d) * up + up / 2.0
        rows, cols = r0[:, None, None] + k[None, :, None], c0[:, None, None] + k[None, None, :]
        coords = np.stack(np.broadcast_arrays(rows, cols), axis=-1).reshape(-1, 2).astype(np.float32)
        cam = generate_rays(self.scene.cameras, torch.from_numpy(np.repeat(cams, d * d)).to(dev),
                            torch.from_numpy(coords).to(dev))
        scale = 1.0 / 255.0 if self.images.dtype == np.uint8 else 1.0
        image = np.stack([self.images[c, r:r + gt, q:q + gt] for c, r, q in zip(cams, r0, c0)]).astype(np.float32)
        which = rng.integers(0, self.points.shape[0], size=self.n_lidar)
        pts = self.points[which]
        lidar = generate_lidar_rays_from_points(self.scene.lidars, torch.from_numpy(self.scan_ids[which]).to(dev),
                                                torch.from_numpy(pts).to(dev))
        batch = {"image": torch.from_numpy(image * scale).to(dev), "distance": lidar.metadata["directions_norm"],
                 "did_return": lidar.metadata["did_return"],
                 "intensity": torch.from_numpy(np.ascontiguousarray(pts[:, 3:4])).to(dev)}
        return _camera_then_lidar(cam, lidar), batch


def _camera_then_lidar(cam: RayBundle, lidar: RayBundle) -> RayBundle:
    """One bundle, camera rays first, with the metadata the model reads
    (`sensor_idxs`, `directions_norm`, `did_return`, `is_lidar`) and nears,
    fars and times filled where a sensor gives none."""
    n_cam, n_lidar = cam.origins.shape[0], lidar.origins.shape[0]
    dev = cam.origins.device

    def flags(n, value):
        return torch.full((n, 1), value, dtype=torch.bool, device=dev)

    meta = (
        {"sensor_idxs": cam.metadata.get("sensor_idxs", torch.zeros((n_cam, 1), dtype=torch.int32, device=dev)),
         "directions_norm": cam.metadata["directions_norm"], "did_return": flags(n_cam, True),
         "is_lidar": flags(n_cam, False)},
        {"sensor_idxs": lidar.metadata.get("sensor_idxs", torch.ones((n_lidar, 1), dtype=torch.int32, device=dev)),
         "directions_norm": lidar.metadata["directions_norm"], "did_return": lidar.metadata["did_return"],
         "is_lidar": flags(n_lidar, True)},
    )

    def filled(b: RayBundle, n: int, name: str, value: float) -> torch.Tensor:
        x = getattr(b, name)
        return x if x is not None else torch.full((n, 1), value, device=dev)

    def cat(x, y):
        return torch.cat([x, y.to(x.dtype)], dim=0)

    parts = ((cam, n_cam), (lidar, n_lidar))
    return RayBundle(
        origins=cat(cam.origins, lidar.origins), directions=cat(cam.directions, lidar.directions),
        pixel_area=cat(cam.pixel_area, lidar.pixel_area), camera_indices=cat(cam.camera_indices, lidar.camera_indices),
        nears=cat(*(filled(b, n, "nears", 0.0) for b, n in parts)),
        fars=cat(*(filled(b, n, "fars", 1e6) for b, n in parts)),
        times=cat(*(filled(b, n, "times", 0.0) for b, n in parts)),
        metadata={k: cat(meta[0][k], meta[1][k]) for k in meta[0]},
    )


class NeuRADTrain:
    def __init__(self, train: dict, scene, weights: Dict[str, torch.Tensor], device, precision: str = "stated",
                 model: Optional[dict] = None):
        self.device = torch.device(device)
        self.chunk = int(train["train_ray_chunk"])
        self.num_cam_rays = int(train["num_cam_patches"]) * int(train["patch_size"]) ** 2
        self.patch = (int(train["patch_size"]),) * 2
        kwargs = dict(
            actor_data=actor_data_from_trajectories(scene.trajectories),
            static_scale=float(np.abs(np.asarray(scene.scene_box.aabb)).max()),
            num_sensors=len(scene.sensor_idx_to_name),
            duration=scene.duration,
            num_train_images=len(scene.images),
            rgb_upsample_factor=int(train["rgb_upsample_factor"]),
        )
        kwargs.update(model or {})
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            m = NeuRADModel(generator=torch.Generator(device=self.device).manual_seed(0), **kwargs)
        self.model = m.to(self.device).eval()
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, w in weights.items():
                params[name].copy_(w)
        self.precision = precision
        if precision != "stated":
            set_precision(self.model, precision)
        self.sampler = BatchSampler(train, scene, self.device)
        self.vgg = None
        if self.model.loss.vgg_mult > 0.0:
            self.vgg = load_vgg19_params(torch.Generator().manual_seed(VGG_SEED), device=self.device)
        groups = {g: OptimizerGroupConfig(**v) for g, v in train["optimizer_groups"].items()}
        self.optimizers = Optimizers(self.model.named_parameters(), groups, DEFAULT_GROUP_RULES)
        self.initial = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.fault = ""  # "half": a planted fault, the loss of half the batch (for the check's own test)

    def _chunks(self, n: int) -> List[int]:
        return [self.chunk] * math.ceil(n / self.chunk) if self.chunk and n > self.chunk else [n]

    def draw(self, generator: torch.Generator, n: int) -> list:
        """(jitters per round, flip) of each chunk, in the pipeline's order."""
        sampling = self.model.sampling
        counts = list(sampling.num_proposal_samples) + [sampling.num_nerf_samples]
        out = []
        for r in self._chunks(n):
            jitters = tuple(torch.rand((r, 1 if sampling.single_jitter else s + 1), generator=generator,
                                       device=self.device) for s in counts)
            out.append((jitters, torch.rand((r,), generator=generator, device=self.device)))
        return out

    def loss(self, bundle: RayBundle, batch: Dict[str, torch.Tensor], draws: Sequence, num_cam_rays: int
             ) -> torch.Tensor:
        n = bundle.origins.shape[0]
        chunks = self._chunks(n)
        model = self.model
        if len(chunks) == 1:
            jit, flip = draws[0]
            out = model.get_nff_outputs(bundle, num_cam_rays, jitters=jit, flip_draw=flip, train=True)
        else:
            chunk, total = chunks[0], chunks[0] * len(chunks)
            padded = map_tensors(lambda x: torch.cat([x, x[-1:].expand((total - n,) + x.shape[1:])], dim=0), bundle)
            outs = []
            for i, (jit, flip) in enumerate(draws):
                piece = map_tensors(lambda x: x[i * chunk:(i + 1) * chunk], padded)
                outs.append(model.get_nff_outputs(piece, 0, jitters=jit, flip_draw=flip, train=True))
            out = {k: torch.cat([o[k] for o in outs], dim=0)[:n] for k in outs[0]}
        features = out.pop("features")
        rgb, intensity, ray_drop = model.decode_features(features, self.patch, num_cam_rays, train=True)
        if rgb is not None:
            out["rgb"] = rgb
        if intensity is not None:
            out["intensity"], out["ray_drop_logits"] = intensity, ray_drop
        total, _ = model.compute_losses(out, batch, num_cam_rays, vgg=self.vgg)
        return total

    def _half(self, bundle: RayBundle, batch: Dict[str, torch.Tensor]):
        """The first half of the batch's camera patches and of its lidar rays."""
        n_cam, n = self.num_cam_rays, bundle.origins.shape[0]
        cam, lid = n_cam // 2 // self.patch[0] ** 2 * self.patch[0] ** 2, (n - n_cam) // 2
        rows = torch.cat([torch.arange(cam), torch.arange(n_cam, n_cam + lid)]).to(self.device)
        bundle = map_tensors(lambda x: x[rows], bundle)
        patches = cam // self.patch[0] ** 2
        batch = {k: (v[:patches] if k == "image" else v[:lid]) for k, v in batch.items()}
        return bundle, batch, cam

    def step(self, sampler_state: dict, generator_state: Optional[torch.Tensor] = None,
             draws: Optional[Sequence] = None) -> float:
        """One update on the batch that the sampler in `sampler_state` draws,
        with the jitters and flips that the port's step generator in
        `generator_state` draws (or `draws`, as `draw` returns them) -> the
        step's loss."""
        bundle, batch = self.sampler(sampler_state)
        num_cam_rays = self.num_cam_rays
        if self.fault == "half":
            bundle, batch, num_cam_rays = self._half(bundle, batch)
        if draws is None:
            gen = torch.Generator(device=self.device)
            gen.set_state(generator_state)
            draws = self.draw(gen, bundle.origins.shape[0])
        with precision_context(self.precision):
            total = self.loss(bundle, batch, draws, num_cam_rays)
            self.optimizers.zero_grad()
            total.backward()
        self.optimizers.step()
        return float(total.detach())

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Each parameter's Adam first moment (after one step: (1 - beta1) x its gradient)."""
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
