"""Score Distillation Sampling guidance (DreamFusion) with a Stable Diffusion
backbone (torch port of `neurad_tpu/generative/stable_diffusion.py`).

Reference: `nerfstudio/generative/stable_diffusion.py` (the `gen` optional
extra).

- The SDS math (noise schedule, latent noising, classifier-free guidance,
  the score-distillation gradient trick) is tensor code: `sds_loss`,
  `add_noise`, `classifier_free_guidance`, `scaled_linear_alphas_cumprod`.
  It is tested without pretrained weights.
- The diffusion backbone (UNet, VAE, text encoder) is a `diffusers` model,
  loaded onto the guidance object's device (the card unless asked for the
  CPU). The UNet's noise prediction carries no gradient in SDS
  (`stable_diffusion.py:148-155` runs it under no_grad): the SDS gradient
  with respect to the rendered image flows only through the latents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from neurad_tpu_torch import resolve_device

IMG_DIM = 512
CONST_SCALE = 0.18215  # SD latent scaling (stable_diffusion.py:34)
SD_IDENTIFIERS = {
    "1-5": "runwayml/stable-diffusion-v1-5",
    "2-0": "stabilityai/stable-diffusion-2-base",
    "2-1": "stabilityai/stable-diffusion-2-1-base",
}


def scaled_linear_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    device=None,
) -> torch.Tensor:
    """Cumulative alpha products [num_train_timesteps] (fp32) of SD's
    "scaled_linear" beta schedule (PNDMScheduler defaults,
    `stable_diffusion.py:67-73`): the betas are linear in sqrt space."""
    betas = torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def add_noise(
    latents: torch.Tensor, noise: torch.Tensor, alphas_cumprod: torch.Tensor, t: Union[int, torch.Tensor]
) -> torch.Tensor:
    """Forward-diffuse latents to timestep t: sqrt(a_t) x0 + sqrt(1 - a_t) eps."""
    a = alphas_cumprod[t]
    return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise


def classifier_free_guidance(
    noise_pred_text: torch.Tensor, noise_pred_uncond: torch.Tensor, guidance_scale: float
) -> torch.Tensor:
    """The reference's CFG form for SDS, text + scale * (text - uncond)
    (`stable_diffusion.py:159`)."""
    return noise_pred_text + guidance_scale * (noise_pred_text - noise_pred_uncond)


def sds_loss(
    latents: torch.Tensor,
    noise: torch.Tensor,
    noise_pred: torch.Tensor,
    alphas_cumprod: torch.Tensor,
    t: Union[int, torch.Tensor],
) -> torch.Tensor:
    """Score Distillation Sampling loss (`stable_diffusion.py:128-170`):
    0.5 * ||latents - sg(latents - w(t) (noise_pred - noise))||^2 / B, with
    w(t) = 1 - a_t and NaNs of the score zeroed. Its gradient with respect to
    `latents` is w(t) (noise_pred - noise) / B, the DreamFusion score
    gradient; nothing flows into `noise_pred`."""
    w = 1.0 - alphas_cumprod[t]
    grad = torch.nan_to_num(w * (noise_pred - noise))
    target = (latents - grad).detach()
    return 0.5 * torch.sum((latents - target) ** 2) / latents.shape[0]


@dataclasses.dataclass
class StableDiffusionGuidance:
    """Stable Diffusion wrapper for SDS guidance (`stable_diffusion.py:42-91`).

    Construction needs the optional `diffusers` package and downloads the
    pretrained weights of `version`; it raises ImportError without
    `diffusers`. Everything numerical above works without it. The backbone
    runs on `device`, the card unless the caller asks for the CPU."""

    version: str = "1-5"
    num_train_timesteps: int = 1000
    t_range: Tuple[float, float] = (0.02, 0.98)
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        try:
            from diffusers import StableDiffusionPipeline
        except ImportError as e:  # the reference gates its `gen` extra the same way
            raise ImportError(
                "Stable Diffusion guidance needs the optional `diffusers` package "
                "(reference: `pip install nerfstudio[gen]`). The SDS math in this "
                "module works without it; only the pretrained backbone is gated."
            ) from e
        self.device = resolve_device(self.device)
        self.min_step = int(self.num_train_timesteps * self.t_range[0])
        self.max_step = int(self.num_train_timesteps * self.t_range[1])
        self.alphas_cumprod = scaled_linear_alphas_cumprod(self.num_train_timesteps, device=self.device)

        pipe = StableDiffusionPipeline.from_pretrained(SD_IDENTIFIERS[self.version], torch_dtype=torch.float32)
        pipe = pipe.to(self.device)
        pipe.enable_attention_slicing()
        self.unet = pipe.unet
        self.tokenizer = pipe.tokenizer
        self.text_encoder = pipe.text_encoder
        self.vae = pipe.vae

    @torch.no_grad()
    def get_text_embeds(self, prompt: str, negative_prompt: str = "") -> torch.Tensor:
        """[2, L, D] (uncond, cond) text embeddings (`stable_diffusion.py:93-126`)."""
        embeds = []
        for p in (negative_prompt, prompt):
            tokens = self.tokenizer(p, padding="max_length", max_length=self.tokenizer.model_max_length,
                                    truncation=True, return_tensors="pt")
            embeds.append(self.text_encoder(tokens.input_ids.to(self.device))[0])
        return torch.cat(embeds)

    @torch.no_grad()
    def predict_noise(self, latents_noisy: torch.Tensor, t: int, text_embeddings: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(uncond, text) noise predictions of the UNet, without gradients."""
        lat = latents_noisy.to(self.device)
        pred = self.unet(torch.cat([lat, lat]), t, encoder_hidden_states=text_embeddings.to(self.device)).sample
        uncond, text = pred.chunk(2)
        return uncond, text

    @torch.no_grad()
    def imgs_to_latent(self, imgs: torch.Tensor) -> torch.Tensor:
        """Images [B, 3, H, W] in [0, 1] -> latents [B, 4, H/8, W/8]
        (`stable_diffusion.py:242-254`)."""
        posterior = self.vae.encode(imgs.to(self.device) * 2 - 1).latent_dist
        return posterior.mean * CONST_SCALE

    @torch.no_grad()
    def latents_to_img(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> images [B, 3, H, W] in [0, 1] (`stable_diffusion.py:225-240`)."""
        imgs = self.vae.decode(latents.to(self.device) / CONST_SCALE).sample
        return (imgs / 2 + 0.5).clamp(0, 1)

    def sds_loss_for_image(
        self,
        generator: torch.Generator,
        image_latents: torch.Tensor,
        text_embeddings: torch.Tensor,
        guidance_scale: float = 100.0,
        t: Optional[int] = None,
    ) -> torch.Tensor:
        """One SDS guidance step: draw t in [min_step, max_step] (unless
        given) and the noise from `generator`, noise the latents, query the
        UNet without gradients, and return the loss whose gradient with
        respect to `image_latents` is the score-distillation gradient."""
        if t is None:
            t = int(torch.randint(self.min_step, self.max_step + 1, (), generator=generator,
                                  device=generator.device))
        noise = torch.randn(image_latents.shape, generator=generator, device=generator.device,
                            dtype=image_latents.dtype).to(image_latents.device)
        noisy = add_noise(image_latents.detach(), noise, self.alphas_cumprod, t)
        uncond, text = self.predict_noise(noisy, t, text_embeddings)
        noise_pred = classifier_free_guidance(text, uncond, guidance_scale)
        return sds_loss(image_latents, noise, noise_pred, self.alphas_cumprod, t)
