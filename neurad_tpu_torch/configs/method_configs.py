"""Method presets: full training configurations by name (torch port of
`neurad_tpu/configs/method_configs.py`, the methods the port trains).

  neurad         NeuRAD at the preset's full width: 40 camera patches of 32 x 32
                 rays and 16,384 lidar rays a batch, feature-field renders of
                 8,192 rays, VGG perceptual loss on, five Adam groups
  neurad-tiny    a few levels and narrow widths, VGG off (CPU smoke runs, tests)
  neurad-parity  the reference's architecture and numerics: hash-grid proposal
                 fields, one table row per grid corner, every level hashed,
                 fp32 reads and MLPs
  splatad, splatad-default, splatad-tiny   SplatAD (MCMC or Default densification)

`pipeline_type` says which pipeline trains a method: "ad" (ray batches,
`ADPipeline`) or "splatad" (full sensors, `SplatADPipeline`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Union

from neurad_tpu_torch.data.datamanager import ADDataManagerConfig
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig
from neurad_tpu_torch.engine.optimizers import NEURAD_OPTIMIZER_GROUPS, OptimizerGroupConfig
from neurad_tpu_torch.fields.neurad_encoding import ActorSettings, StaticSettings
from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig
from neurad_tpu_torch.models.neurad import LossSettings, SamplingSettings
from neurad_tpu_torch.models.splatad import SplatADConfig
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipelineConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipelineConfig


@dataclasses.dataclass
class TrainerConfig:
    max_num_iterations: int = 30001
    steps_per_save: int = 2000
    steps_per_log: int = 100
    steps_per_eval_batch: int = 500  # the train loop runs `pipeline.eval_metrics()` every this many steps


@dataclasses.dataclass
class MethodConfig:
    method_name: str
    trainer: TrainerConfig
    pipeline: Union[ADPipelineConfig, SplatADPipelineConfig]
    dataparser: str = "synthetic"
    pipeline_type: str = "ad"  # "ad" (ray batches) | "splatad" (full sensors)


def neurad_tiny_overrides() -> dict:
    """Model overrides of the `neurad-tiny` preset (CPU smoke widths)."""
    proposal = StaticSettings(num_levels=2, base_res=16, max_res=128, log2_hashmap_size=11, hashgrid_dim=1)
    return dict(
        loss=LossSettings(vgg_mult=0.0),  # VGG's conv stack is many times the tiny model's step
        sampling=SamplingSettings(num_proposal_samples=(12, 8), num_nerf_samples=6, sky_distance=1000.0),
        field_static=StaticSettings(num_levels=4, base_res=16, max_res=256, log2_hashmap_size=13, hashgrid_dim=4),
        field_actor=ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=11, hashgrid_dim=4),
        proposal_static=(proposal, proposal),
        proposal_actor=ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=9, hashgrid_dim=1),
        appearance_dim=4,
        max_actors_per_ray=1,
    )


def _neurad() -> MethodConfig:
    return MethodConfig(
        "neurad",
        TrainerConfig(max_num_iterations=20001, steps_per_save=2000, steps_per_log=100, steps_per_eval_batch=500),
        ADPipelineConfig(
            datamanager=ADDataManagerConfig(num_cam_patches=40, patch_size=32, num_lidar_rays=16384),
            model_overrides=dict(sampling=SamplingSettings()),
            optimizer_groups=dict(NEURAD_OPTIMIZER_GROUPS),
        ),
    )


def _neurad_parity() -> MethodConfig:
    cfg = _neurad()
    cfg.method_name = "neurad-parity"
    cfg.pipeline.model_overrides = dict(
        cfg.pipeline.model_overrides,
        proposal_mode="hashgrid",
        compute_fp32=True,
        field_static=StaticSettings(cell_packed=False, parity=True),
        field_actor=ActorSettings(flip_prob=0.25, cell_packed=False, parity=True),
        proposal_static=(
            StaticSettings(log2_hashmap_size=20, num_levels=6, max_res=4096, base_res=128, hashgrid_dim=1,
                           cell_packed=False, parity=True),
        ) * 2,
        proposal_actor=ActorSettings(log2_hashmap_size=15, num_levels=4, base_res=64, max_res=1024, hashgrid_dim=1,
                                     cell_packed=False, parity=True),
    )
    cfg.pipeline.train_ray_chunk = 8192
    return cfg


def _neurad_tiny() -> MethodConfig:
    return MethodConfig(
        "neurad-tiny",
        TrainerConfig(max_num_iterations=200, steps_per_save=10**9, steps_per_log=20, steps_per_eval_batch=100),
        ADPipelineConfig(
            datamanager=ADDataManagerConfig(num_cam_patches=4, patch_size=6, num_lidar_rays=256),
            model_overrides=neurad_tiny_overrides(),
            optimizer_groups={
                "fields": OptimizerGroupConfig(lr=5e-3, warmup_steps=0),
                "hashgrids": OptimizerGroupConfig(lr=5e-3, warmup_steps=0),
                "cnn": OptimizerGroupConfig(lr=5e-3, warmup_steps=0),
                "trajectory_opt": OptimizerGroupConfig(lr=1e-4, warmup_steps=0),
                "camera_opt": OptimizerGroupConfig(lr=1e-4, warmup_steps=0),
            },
        ),
    )


def _splatad(strategy: str = "mcmc") -> MethodConfig:
    name = "splatad" if strategy == "mcmc" else "splatad-default"
    return MethodConfig(name, TrainerConfig(steps_per_eval_batch=500), SplatADPipelineConfig(strategy=strategy),
                        pipeline_type="splatad")


def _splatad_tiny() -> MethodConfig:
    return MethodConfig(
        "splatad-tiny",
        TrainerConfig(max_num_iterations=100, steps_per_save=10**9, steps_per_log=10, steps_per_eval_batch=50),
        SplatADPipelineConfig(
            datamanager=FullImageLidarDataManagerConfig(max_lidar_points=512),
            model=SplatADConfig(num_downscales=0, feature_dim=8, appearance_dim=4, max_per_tile=64, lidar_max_per_tile=32),
            mcmc=MCMCStrategyConfig(cap_max=2048, refine_start_iter=10, refine_every=25),
            cap_max=2048,
        ),
        pipeline_type="splatad",
    )


METHODS: Dict[str, Callable[[], MethodConfig]] = {
    "neurad": _neurad,
    "neurad-tiny": _neurad_tiny,
    "neurad-parity": _neurad_parity,
    "splatad": _splatad,
    "splatad-default": lambda: _splatad("default"),
    "splatad-tiny": _splatad_tiny,
}
