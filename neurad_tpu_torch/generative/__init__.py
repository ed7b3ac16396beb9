"""Generative guidance: Score Distillation Sampling (torch port of
`neurad_tpu/generative/`; the reference's `nerfstudio/generative/`).

The SDS math, the noise schedule and the view-conditioned prompt embeddings
are plain tensor functions, tested without any pretrained model. The
diffusion backbone is loaded through HuggingFace `diffusers`, which is
optional: `StableDiffusionGuidance` raises ImportError without it.
"""

from neurad_tpu_torch.generative.positional_text_embeddings import PositionalTextEmbeddings
from neurad_tpu_torch.generative.stable_diffusion import (
    StableDiffusionGuidance,
    scaled_linear_alphas_cumprod,
    sds_loss,
)

__all__ = [
    "PositionalTextEmbeddings",
    "StableDiffusionGuidance",
    "scaled_linear_alphas_cumprod",
    "sds_loss",
]
